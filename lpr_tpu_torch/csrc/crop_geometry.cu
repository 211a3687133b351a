// G1 — the recognizer step's plate crops as one kernel, written by hand for
// Hopper (sm_90a), bound to Python through the plain C launchers at the
// bottom (lpr_tpu_torch/kernels/crop_geometry.py loads them with ctypes).
//
// Replaces no Pallas kernel: the JAX package phrases every crop as dense
// interpolation matrices for the TPU's matrix unit (lpr_tpu/ops/resample.py)
// and leaves them to XLA.  Carried over as they were (the plain version,
// ops/resample.py), each crop builds a hat matrix over the whole source axis
// whose rows hold two nonzero taps: about a billion float32 elements a
// 32-frame step, built by elementwise passes and read by products whose N is
// the 3 channels.  The work itself is two taps a value in each pass.
//
// What it computes, per plate slot (b, p) of frames (B, H, W, 3) and boxes
// (B, P, 4) xyxy in frame pixels, as PlateRecognizer._per_plate composes it
// from ops/resample.py plate_tile + crop_rotated_fast and ops/image.py
// estimate_skew_angle:
//   1. the 64x256 plate tile (plate_tile): an axis-aligned region around the
//      box with room for a 15 degree rotation, each value a separable
//      two-tap lerp of the frame, positions clipped to the frame (border
//      replicate), tap weights normalised as extract_tile normalises them;
//   2. the 32x96 crop at angle 0, its grey values, 3x3 Sobel gradients
//      (replicate border), the structure tensor's two means and the
//      straightening angle (max 15 degrees, the crop's pixel aspect);
//      angle 0 without deskew;
//   3. the crops at that angle: 32x192 for a long plate, else the 32x96 top
//      and bottom halves side by side (only the layout is_long selects is
//      computed), and the 128x128 square crop masked outside the box.  Each
//      output pixel is the composition of affine_resample's two
//      Catmull-Smith passes: two taps in pass 2, each a two-tap lerp of a
//      tile row in pass 1, with its positions, its clip and its guard on d.
// Outputs long_img (B, P, sh, sw, 3) and ocr (B, P, oh, ow, 3) in the frame
// type, is_long (B, P) bool and the angle (B, P) float32.
//
// Precision: every position, weight and sum is float32 and each output is
// rounded once to the frame type (the plain version rounds the tile, each
// pass and its weights to bf16 in a bf16 step).  The positions are computed
// in the plain version's operation order, without contraction into FMAs
// (__fmul_rn / __fadd_rn), and a division by a Python scalar as PyTorch's
// CUDA kernels do it, by the reciprocal.
//
// What bounds it: bytes.  A plate slot reads the frame pixels its tile's
// taps touch (the box's region with its margins; each is tapped up to four
// times, from L1/L2) and writes 22,528 output pixels (135 KB in bf16): at
// batch 32 with 3 slots a frame of 720p, 21 MB read and written once
// (kernels/crop_geometry.py crop_work), 6.3 us at 3.35 TB/s; on an H100
// the kernel takes 37 us, against 18.6 ms for the dense matrices in bf16.
//
// Design.  One block of 512 threads a plate slot.  The tile lives in
// shared memory in float32 (196,608 B, one block an SM), planar by
// channel so neighbouring threads read neighbouring words; every crop
// reads it there, so the pass-1 rows are never written anywhere.  The
// tile's tap tables (64 rows, 256 columns) are computed once per block, and
// the crop parameters (the affine map's coefficients) once per crop.  The
// angle's sums are reduced by warp shuffles and then by one thread, in a
// fixed order, so a run is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 64, TW = 256;    // the plate tile
constexpr int KH = 32, KW = 96;     // the skew estimate's crop
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int SMEM_BYTES = (3 * TH * TW + KH * KW) * 4;

// The crops of a block, in crops[]: the skew crop, the long crop, its two
// halves and the OCR crop.
enum { C_SKEW, C_FULL, C_TOP, C_BOT, C_OCR, N_CROPS };

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// torch.clamp(v, lo, hi) (a NaN stays NaN).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The plate's box geometry (plate_tile): centre, clamped size, the tile's
// extent and its scale (frame px -> tile px).
struct Plate {
  float cx, cy, bw, bh, side, ew, eh, su, sv;
};

__device__ Plate plate_geom(const float* box) {
  const float slack = (float)0.2679491924311227;   // tan(15 degrees)
  const float grow = (float)1.05;
  Plate g;
  g.cx = __fmul_rn(__fadd_rn(box[0], box[2]), 0.5f);
  g.cy = __fmul_rn(__fadd_rn(box[1], box[3]), 0.5f);
  float w = __fsub_rn(box[2], box[0]), h = __fsub_rn(box[3], box[1]);
  g.bw = w < 1.f ? 1.f : w;
  g.bh = h < 1.f ? 1.f : h;
  g.side = fmaxf(g.bw, g.bh);
  g.ew = __fadd_rn(__fmul_rn(grow, g.side), __fmul_rn(slack, g.bh));
  g.eh = __fadd_rn(__fmul_rn(grow, g.bh), __fmul_rn(slack, g.side));
  g.su = __fmul_rn(__frcp_rn(g.ew), (float)TW);   // tw / ew: reciprocal * tw
  g.sv = __fmul_rn(__frcp_rn(g.eh), (float)TH);
  return g;
}

// Two taps of a hat row (interp_weights): position clipped to [0, n - 1],
// weights clamp(1 - |pos - src|, 0, 1); the second tap reads the last
// sample with weight 0 where pos is n - 1.  `normalise` divides both by
// their sum (extract_tile's _normalised).
struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps hat_taps(float pos, int n, bool normalise) {
  pos = clampf(pos, 0.f, (float)(n - 1));
  float k = floorf(pos);
  Taps t;
  t.i0 = (int)k;
  t.i1 = min(t.i0 + 1, n - 1);
  t.w0 = clampf(__fsub_rn(1.f, fabsf(__fsub_rn(pos, k))), 0.f, 1.f);
  t.w1 = t.i0 + 1 < n
             ? clampf(__fsub_rn(1.f, fabsf(__fsub_rn(pos, k + 1.f))), 0.f, 1.f)
             : 0.f;
  if (normalise) {
    float s = __fadd_rn(t.w0, t.w1);
    s = s < 1e-8f ? 1e-8f : s;
    t.w0 = __fdiv_rn(t.w0, s);
    t.w1 = __fdiv_rn(t.w1, s);
  }
  return t;
}

// One crop's affine map in affine_resample's terms: pass 1 samples tile
// row r at u = (j * a1 + r * bd) + t1, pass 2 samples column j at
// v = (c * j + d * i) + tv.
struct Crop {
  float a1, bd, t1, c, d, tv;
};

// The source (u, v) in tile px of output pixel (i, j) in {0, 1}^2
// (crop_rotated_fast's src_uv): du, dv are the Python constants of the
// pixel's box-relative offset, cast to float32 as PyTorch casts a scalar.
__device__ __forceinline__ float2 src_uv(const Plate& g, float ca, float sa,
                                         float wspan, float hspan, float duk,
                                         float dvk) {
  float du = __fmul_rn(duk, wspan), dv = __fmul_rn(dvk, hspan);
  float xf = __fsub_rn(__fsub_rn(__fadd_rn(g.cx, __fmul_rn(du, ca)),
                                 __fmul_rn(dv, sa)), 0.5f);
  float yf = __fsub_rn(__fadd_rn(__fadd_rn(g.cy, __fmul_rn(du, sa)),
                                 __fmul_rn(dv, ca)), 0.5f);
  float u = __fadd_rn(__fmul_rn(__fsub_rn(xf, __fsub_rn(g.cx, 0.5f)), g.su),
                      (float)((TW - 1) / 2.0));
  float v = __fadd_rn(__fmul_rn(__fsub_rn(yf, __fsub_rn(g.cy, 0.5f)), g.sv),
                      (float)((TH - 1) / 2.0));
  return make_float2(u, v);
}

__device__ Crop crop_params(const Plate& g, float angle, int oh, int ow,
                            double v0, double v1, bool square) {
  float ca = cosf(angle), sa = sinf(angle);
  float wspan = square ? g.side : g.bw, hspan = square ? g.side : g.bh;
  float du0 = (float)((0.0 + 0.5) / ow - 0.5);
  float du1 = (float)((1.0 + 0.5) / ow - 0.5);
  float dv0 = (float)(v0 + (0.0 + 0.5) / oh * (v1 - v0));
  float dv1 = (float)(v0 + (1.0 + 0.5) / oh * (v1 - v0));
  float2 o = src_uv(g, ca, sa, wspan, hspan, du0, dv0);
  float2 at_j = src_uv(g, ca, sa, wspan, hspan, du1, dv0);
  float2 at_i = src_uv(g, ca, sa, wspan, hspan, du0, dv1);
  float a = __fsub_rn(at_j.x, o.x), c = __fsub_rn(at_j.y, o.y);
  float b = __fsub_rn(at_i.x, o.x), d = __fsub_rn(at_i.y, o.y);
  if (fabsf(d) < 1e-3f) {   // sign(d) * 1e-3 + (d == 0) * 1e-3
    float sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
    d = __fadd_rn(__fmul_rn(sgn, 1e-3f), d == 0.f ? 1e-3f : 0.f);
  }
  Crop k;
  k.a1 = __fsub_rn(a, __fdiv_rn(__fmul_rn(b, c), d));
  k.bd = __fdiv_rn(b, d);
  k.t1 = __fsub_rn(o.x, __fdiv_rn(__fmul_rn(b, o.y), d));
  k.c = c;
  k.d = d;
  k.tv = o.y;
  return k;
}

// Channel ch of tile row r sampled at pass 1's position for column j.
__device__ __forceinline__ void pass1(const float* tile, const Crop& k, int r,
                                      float j, float out[3]) {
  float u = __fadd_rn(__fadd_rn(__fmul_rn(j, k.a1), __fmul_rn((float)r, k.bd)),
                      k.t1);
  Taps t = hat_taps(u, TW, false);
  const float* row = tile + r * TW;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* p = row + ch * TH * TW;
    out[ch] = fmaf(t.w1, p[t.i1], t.w0 * p[t.i0]);
  }
}

// Output pixel (i, j) of crop k: pass 2's two taps over pass 1's rows.
__device__ __forceinline__ void sample(const float* tile, const Crop& k,
                                       int i, int j, float out[3]) {
  float jf = (float)j;
  float v = __fadd_rn(__fadd_rn(__fmul_rn(k.c, jf), __fmul_rn(k.d, (float)i)),
                      k.tv);
  Taps t = hat_taps(v, TH, false);
  float f0[3], f1[3];
  pass1(tile, k, t.i0, jf, f0);
  pass1(tile, k, t.i1, jf, f1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = fmaf(t.w1, f1[ch], t.w0 * f0[ch]);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
crop_geometry_kernel(const T* __restrict__ frames,
                     const float* __restrict__ boxes, int P, int H, int W,
                     int sh, int sw, int oh, int ow, float long_aspect,
                     int deskew, T* __restrict__ long_img,
                     T* __restrict__ ocr, uint8_t* __restrict__ is_long,
                     float* __restrict__ angle_out) {
  extern __shared__ float smem[];
  float* tile = smem;                     // [3][TH][TW]
  float* gray = smem + 3 * TH * TW;       // [KH][KW]
  __shared__ Taps row_taps[TH], col_taps[TW];
  __shared__ Crop crops[N_CROPS];
  __shared__ float red[2][NWARPS];
  __shared__ float s_angle;
  __shared__ int s_long;

  const int slot = blockIdx.x, b = slot / P, tid = threadIdx.x;
  const Plate g = plate_geom(boxes + 4 * (size_t)slot);
  const T* frame = frames + (size_t)b * H * W * 3;

  // The tile's taps (extract_tile): ys = cy - eh/2 + (t + 0.5) * (eh/th)
  // - 0.5, xs likewise; eh/2, eh/th and ew/tw are exact scalings.
  if (tid < TH) {
    float y = __fsub_rn(__fadd_rn(__fsub_rn(g.cy, __fmul_rn(g.eh, 0.5f)),
                                  __fmul_rn(tid + 0.5f,
                                            __fmul_rn(g.eh, 1.f / TH))),
                        0.5f);
    row_taps[tid] = hat_taps(y, H, true);
  } else if (tid < TH + TW) {
    int q = tid - TH;
    float x = __fsub_rn(__fadd_rn(__fsub_rn(g.cx, __fmul_rn(g.ew, 0.5f)),
                                  __fmul_rn(q + 0.5f,
                                            __fmul_rn(g.ew, 1.f / TW))),
                        0.5f);
    col_taps[q] = hat_taps(x, W, true);
  } else if (tid == TH + TW) {
    crops[C_SKEW] = crop_params(g, 0.f, KH, KW, -0.5, 0.5, false);
  }
  __syncthreads();

  // 1. The tile: the rows' taps first, then the columns' (the order of
  // extract_tile's two products).
  for (int p = tid; p < TH * TW; p += NTHREADS) {
    const int r = p / TW, q = p % TW;
    const Taps ty = row_taps[r], tx = col_taps[q];
    const T* f00 = frame + ((size_t)ty.i0 * W + tx.i0) * 3;
    const T* f01 = frame + ((size_t)ty.i0 * W + tx.i1) * 3;
    const T* f10 = frame + ((size_t)ty.i1 * W + tx.i0) * 3;
    const T* f11 = frame + ((size_t)ty.i1 * W + tx.i1) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float left = fmaf(ty.w1, load(f10 + ch), ty.w0 * load(f00 + ch));
      float right = fmaf(ty.w1, load(f11 + ch), ty.w0 * load(f01 + ch));
      tile[ch * TH * TW + p] = fmaf(tx.w1, right, tx.w0 * left);
    }
  }
  __syncthreads();

  // 2. The skew estimate: the crop at angle 0 in grey (BT.601), then the
  // structure tensor's sums.
  for (int p = tid; p < KH * KW; p += NTHREADS) {
    float rgb[3];
    sample(tile, crops[C_SKEW], p / KW, p % KW, rgb);
    gray[p] = fmaf(rgb[2], 0.114f, fmaf(rgb[1], 0.587f, rgb[0] * 0.299f));
  }
  __syncthreads();
  float sxy = 0.f, sdd = 0.f;
  for (int p = tid; p < KH * KW; p += NTHREADS) {
    const int y = p / KW, x = p % KW;
    const int ym = max(y - 1, 0) * KW, yc = y * KW, yp = min(y + 1, KH - 1) * KW;
    const int xm = max(x - 1, 0), xp = min(x + 1, KW - 1);
    float gx = __fsub_rn(
        __fadd_rn(__fadd_rn(gray[ym + xp], __fmul_rn(2.f, gray[yc + xp])),
                  gray[yp + xp]),
        __fadd_rn(__fadd_rn(gray[ym + xm], __fmul_rn(2.f, gray[yc + xm])),
                  gray[yp + xm]));
    float gy = __fsub_rn(
        __fadd_rn(__fadd_rn(gray[yp + xm], __fmul_rn(2.f, gray[yp + x])),
                  gray[yp + xp]),
        __fadd_rn(__fadd_rn(gray[ym + xm], __fmul_rn(2.f, gray[ym + x])),
                  gray[ym + xp]));
    sxy += __fmul_rn(__fmul_rn(2.f, gx), gy);
    sdd += __fsub_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sxy += __shfl_xor_sync(0xffffffffu, sxy, o);
    sdd += __shfl_xor_sync(0xffffffffu, sdd, o);
  }
  if (tid % 32 == 0) {
    red[0][tid / 32] = sxy;
    red[1][tid / 32] = sdd;
  }
  __syncthreads();
  if (tid == 0) {
    float jxy = 0.f, jdd = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      jxy += red[0][w];
      jdd += red[1][w];
    }
    const float inv_n = 1.f / (KH * KW);
    jxy = __fmul_rn(jxy, inv_n);
    jdd = __fmul_rn(jdd, inv_n);
    // estimate_skew_angle: the orientation, the tilt folded into
    // (-pi/2, pi/2], the pixel aspect (w / 96) / (h / 32), the clamp.
    const float half_pi = (float)(3.141592653589793 / 2), pi_f =
        (float)3.141592653589793;
    float theta = __fmul_rn(0.5f, atan2f(jxy, jdd));
    float tilt = __fsub_rn(theta, half_pi);
    if (tilt <= -half_pi) tilt = __fadd_rn(tilt, pi_f);
    if (tilt > half_pi) tilt = __fsub_rn(tilt, pi_f);
    float aspect = __fdiv_rn(__fmul_rn(g.bw, 1.f / 96.f),
                             __fmul_rn(g.bh, 1.f / 32.f));
    tilt = atanf(__fdiv_rn(tanf(tilt), aspect));
    const float lim = (float)(15.0 * 3.141592653589793 / 180.0);
    float angle = clampf(tilt, -lim, lim);
    if (!deskew) angle = __fmul_rn(angle, 0.f);
    s_angle = angle;
    s_long = __fdiv_rn(g.bw, g.bh) > long_aspect;
    angle_out[slot] = angle;
    is_long[slot] = (uint8_t)s_long;
  }
  __syncthreads();
  if (tid < 4) {
    const float angle = s_angle;
    if (tid == 0)
      crops[C_FULL] = crop_params(g, angle, sh, sw, -0.5, 0.5, false);
    else if (tid == 1)
      crops[C_TOP] = crop_params(g, angle, sh, sw / 2, -0.5, 0.0, false);
    else if (tid == 2)
      crops[C_BOT] = crop_params(g, angle, sh, sw / 2, 0.0, 0.5, false);
    else
      crops[C_OCR] = crop_params(g, angle, oh, ow, -0.5, 0.5, true);
  }
  __syncthreads();

  // 3. The long crop, or the two halves side by side.
  const bool lng = s_long;
  const int half = sw / 2;
  T* lo = long_img + (size_t)slot * sh * sw * 3;
  for (int p = tid; p < sh * sw; p += NTHREADS) {
    const int i = p / sw, j = p % sw;
    float rgb[3];
    if (lng)
      sample(tile, crops[C_FULL], i, j, rgb);
    else if (j < half)
      sample(tile, crops[C_TOP], i, j, rgb);
    else
      sample(tile, crops[C_BOT], i, j - half, rgb);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) store(lo + 3 * p + ch, rgb[ch]);
  }

  // The OCR crop: square, zero outside the box (crop_rotated_fast's mask;
  // (i + 0.5) / n as PyTorch computes it on a card, by the reciprocal).
  const float inv_ow = 1.f / (float)ow, inv_oh = 1.f / (float)oh;
  const float bw2 = __fmul_rn(g.bw, 0.5f), bh_lo = __fmul_rn(g.bh, -0.5f),
              bh_hi = __fmul_rn(g.bh, 0.5f);
  T* oo = ocr + (size_t)slot * oh * ow * 3;
  for (int p = tid; p < oh * ow; p += NTHREADS) {
    const int i = p / ow, j = p % ow;
    float du = __fmul_rn(__fsub_rn(__fmul_rn(j + 0.5f, inv_ow), 0.5f), g.side);
    float dv = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(i + 0.5f, inv_oh), 1.f),
                                   -0.5f),
                         g.side);
    float inside = (fabsf(du) <= bw2 && dv >= bh_lo && dv <= bh_hi) ? 1.f : 0.f;
    float rgb[3];
    sample(tile, crops[C_OCR], i, j, rgb);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) store(oo + 3 * p + ch, rgb[ch] * inside);
  }
}

template <typename T>
int launch(const void* frames, const void* boxes, int B, int P, int H, int W,
           int sh, int sw, int oh, int ow, float long_aspect, int deskew,
           void* long_img, void* ocr, void* is_long, void* angle,
           void* stream) {
  if (B <= 0 || P <= 0 || H <= 0 || W <= 0 || sh <= 0 || sw <= 0 ||
      sw % 2 != 0 || oh <= 0 || ow <= 0 || (long long)B * P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      crop_geometry_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  crop_geometry_kernel<T><<<B * P, NTHREADS, SMEM_BYTES,
                            (cudaStream_t)stream>>>(
      (const T*)frames, (const float*)boxes, P, H, W, sh, sw, oh, ow,
      long_aspect, deskew, (T*)long_img, (T*)ocr, (uint8_t*)is_long,
      (float*)angle);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch G1 on `stream`; returns cudaGetLastError() after the launch (0 on
// success), one launcher a crop type (bf16, float32).  frames (B, H, W, 3)
// in the crop type, boxes (B, P, 4)
// float32, long_img (B, P, sh, sw, 3) and ocr (B, P, oh, ow, 3) in the crop
// type, is_long (B, P) bool, angle (B, P) float32; all contiguous.
extern "C" int lpr_crop_geometry_bf16(const void* frames, const void* boxes,
                                      int B, int P, int H, int W, int sh,
                                      int sw, int oh, int ow,
                                      float long_aspect, int deskew,
                                      void* long_img, void* ocr,
                                      void* is_long, void* angle,
                                      void* stream) {
  return launch<bf16>(frames, boxes, B, P, H, W, sh, sw, oh, ow, long_aspect,
                      deskew, long_img, ocr, is_long, angle, stream);
}

extern "C" int lpr_crop_geometry_f32(const void* frames, const void* boxes,
                                     int B, int P, int H, int W, int sh,
                                     int sw, int oh, int ow,
                                     float long_aspect, int deskew,
                                     void* long_img, void* ocr,
                                     void* is_long, void* angle,
                                     void* stream) {
  return launch<float>(frames, boxes, B, P, H, W, sh, sw, oh, ow,
                       long_aspect, deskew, long_img, ocr, is_long, angle,
                       stream);
}

// Dynamic shared memory per block, for reports.
extern "C" int lpr_crop_geometry_smem_bytes(void) { return SMEM_BYTES; }
