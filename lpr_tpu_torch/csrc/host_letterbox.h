// Host letterbox shared by host_letterbox.cc and host_decode.cc: the port's
// copy of `letterbox_into` from native/lpr_native.cc (the JAX package's
// native host data path), with its taps and rounding kept byte for byte.
//
// Built with -ffp-contract=off (kernels/_build.py GXX_FLAGS), so the float32
// taps round at the same points as the numpy reference
// lpr_tpu_torch/ops/image.py `_resize_u8`: a*(1-w) and b*w each rounded,
// then their sum, then + 0.5, truncated to uint8.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace host_letterbox {

// Per-column taps of a bilinear resize from n_in to n_out samples:
// half-pixel centres clamped at 0, the second tap clamped to the last
// sample, the weight in float32.
struct Taps {
  std::vector<int> i0, i1;
  std::vector<float> w;
};

inline Taps taps(int n_in, int n_out) {
  Taps t;
  t.i0.resize(n_out);
  t.i1.resize(n_out);
  t.w.resize(n_out);
  double step = static_cast<double>(n_in) / n_out;
  for (int x = 0; x < n_out; ++x) {
    double f = (x + 0.5) * step - 0.5;
    int i0 = f < 0 ? 0 : static_cast<int>(f);
    t.i0[x] = i0;
    t.i1[x] = i0 + 1 < n_in ? i0 + 1 : n_in - 1;
    double wx = f - i0;
    t.w[x] = wx < 0 ? 0.0f : static_cast<float>(wx);
  }
  return t;
}

// Row y of an (nh, nw) bilinear resize of src (sh, sw, 3) into drow
// (nw * 3 bytes), with the column taps tx of (sw -> nw).
inline void resize_row(const uint8_t* src, int sw, int sh, int nh, int y,
                       const Taps& tx, uint8_t* drow) {
  double fy = (y + 0.5) * (static_cast<double>(sh) / nh) - 0.5;
  int y0 = fy < 0 ? 0 : static_cast<int>(fy);
  int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
  float wy = fy < y0 ? 0.0f : static_cast<float>(fy - y0);
  const uint8_t* s0 = src + static_cast<size_t>(y0) * sw * 3;
  const uint8_t* s1 = src + static_cast<size_t>(y1) * sw * 3;
  int nw = static_cast<int>(tx.w.size());
  for (int x = 0; x < nw; ++x) {
    int x0 = tx.i0[x] * 3, x1 = tx.i1[x] * 3;
    float wx = tx.w[x];
    for (int c = 0; c < 3; ++c) {
      float top_v = s0[x0 + c] * (1 - wx) + s0[x1 + c] * wx;
      float bot_v = s1[x0 + c] * (1 - wx) + s1[x1 + c] * wx;
      drow[x * 3 + c] =
          static_cast<uint8_t>(top_v * (1 - wy) + bot_v * wy + 0.5f);
    }
  }
}

// `letterbox_into` of native/lpr_native.cc: aspect-preserving bilinear
// resize + centre pad of src (sh, sw, 3) into dst (oh, ow, 3), its
// geometry rounded with int(x + 0.5) as the JAX native path rounds it.
inline void letterbox_into(const uint8_t* src, int sw, int sh, uint8_t* dst,
                           int oh, int ow, uint8_t fill) {
  memset(dst, fill, static_cast<size_t>(oh) * ow * 3);
  double r = std::min(static_cast<double>(oh) / sh,
                      static_cast<double>(ow) / sw);
  int nh = std::max(1, static_cast<int>(sh * r + 0.5));
  int nw = std::max(1, static_cast<int>(sw * r + 0.5));
  int top = (oh - nh) / 2, left = (ow - nw) / 2;
  if (nh == sh && nw == sw) {  // pad-only: row memcpy, no resample
    for (int y = 0; y < nh; ++y)
      memcpy(dst + (static_cast<size_t>(top + y) * ow + left) * 3,
             src + static_cast<size_t>(y) * sw * 3,
             static_cast<size_t>(sw) * 3);
    return;
  }
  Taps tx = taps(sw, nw);
  for (int y = 0; y < nh; ++y)
    resize_row(src, sw, sh, nh, y, tx,
               dst + (static_cast<size_t>(top + y) * ow + left) * 3);
}

}  // namespace host_letterbox
