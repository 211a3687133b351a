// K1 — fused front end of the plate detector, written by hand for Hopper
// (sm_90a), bound to Python through the plain C launcher at the bottom
// (lpr_tpu_torch/kernels/yolo_front.py loads it with ctypes).
//
// Replaces the TPU kernel lpr_tpu/ops/pallas/yolo_front.py `front_fused`
// (body `_front_kernel`): yolov5s layers 0-2 with batch norm folded,
//   stem   space-to-depth(2) + 3x3/p1 conv 12->32 + SiLU
//   down   3x3/s2/p1 conv 32->64 + SiLU
//   C3     cv1|cv2 1x1 64->32+32, m.cv1 1x1 32->32, m.cv2 3x3/p1 32->32,
//          residual add onto cv1, cv3 1x1 on [m | cv2] 64->64; SiLU after
//          every conv (with the |y| < 1e-30 -> 0 flush).
// Input: letterboxed frames (B, H, W, 3) bf16 NHWC; output (B, H/4, W/4, 64)
// bf16 NHWC.  H % 32 == 0 and W % 64 == 0 (whole output tiles).
//
// What bounds it: at 736x1280 one image needs 2.98 G multiply-adds against
// 5.65 MB of input and 7.54 MB of output (~450 FLOP per byte), so on this
// card it is compute-bound: ~6.0 us per image at the 989 TFLOP/s bf16
// tensor-core rate, ~3.9 us for the bytes alone.
//
// Design (the simple first version): one thread block per (image, 8x16 tile
// of the H/4 x W/4 output grid).  The block recomputes in shared memory the
// halo each later layer needs (stem tile 21x37, down tile 10x18 with the
// 1-position halo of m.cv2's 3x3), so no intermediate activation goes to
// device memory — what the TPU kernel keeps in VMEM.  Intermediates are
// stored in bf16 and every sum is taken in fp32, as the TPU kernel does.
// Every layer re-zeroes the positions of its tile that lie outside the
// layer's domain, which is the zero padding the next conv expects; blocks
// share nothing, so each one initialises all it reads.  Arithmetic is
// scalar fp32 FMA on the CUDA cores: far from the tensor-core bound; wgmma,
// TMA and a layout for them are later work.
//
// Stage variants (the port of tools/probe_front_stages.py `make_variant`,
// which shows where K1's time goes): the stage is a template parameter of
// front_kernel.  DMA stops after staging the space-to-depth tile, STEM after
// the stem, DOWN after the down conv, FULL is K1.  A cut variant writes K1's
// output shape from the block's own 8x16 tile and returns, so the compiler
// drops every later stage; the production launcher runs the FULL instance.
//   DMA   out(y, x, p*16 + k) = s2d(2y + rho, 2x + pi, k) for plane
//         p = 2*rho + pi and k < 12; channels p*16 + 12..15 are zero.
//   STEM  out(y, x, 0..31) = stem(2y, 2x), out(y, x, 32..63) = stem(2y, 2x+1).
//   DOWN  out(y, x, :) = down(y, x).
//
// Neighbouring threads compute neighbouring positions, so the channel run
// of each position in shared memory is padded by one 4-byte word: its
// stride in words is odd and a warp's loads of one channel pair hit 32
// different banks (unpadded, 32- or 64-channel runs put a whole warp on
// one bank).  Each thread computes PX positions x G output channels, so
// every weight load feeds PX x 2 FMAs.  Three blocks fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;           // output tile rows (H/4 grid)
constexpr int TW = 16;          // output tile cols (W/4 grid)
constexpr int DH = TH + 2;      // down tile with the 1-halo of m.cv2's 3x3
constexpr int DW = TW + 2;
constexpr int SH = 2 * DH + 1;  // stem tile read by the down tile's 3x3/s2
constexpr int SW = 2 * DW + 1;
constexpr int ZH = SH + 2;      // space-to-depth tile read by the stem's 3x3
constexpr int ZW = SW + 2;
constexpr int C0 = 12, C1 = 32, C2 = 64, CM = 32;
constexpr int NTHREADS = 256;
constexpr int G = 8;            // output channels per thread work item
constexpr int PX = 2;           // positions per thread work item
// Channel strides in shared memory (elements): padded by 2 bf16 so that the
// stride in 4-byte words is odd.  The s2d tile stays unpadded (6 words).
constexpr int CS1 = C1 + 2, CS2 = C2 + 2, CSM = CM + 2;

// Region A holds the s2d input tile, later the down tile; region B holds the
// stem tile, later the C3 tensors a (= cv1 | cv2) and bb (= m.cv1).
constexpr int A_ELEMS = (ZH * ZW * C0 > DH * DW * CS2) ? ZH * ZW * C0
                                                       : DH * DW * CS2;
constexpr int B_ELEMS = SH * SW * CS1;
static_assert(DH * DW * (CS2 + CSM) <= B_ELEMS, "a and bb must fit region B");
static_assert((A_ELEMS * 2) % 16 == 0, "region B must stay 16-byte aligned");
constexpr int SMEM_BYTES = (A_ELEMS + B_ELEMS) * 2;

__device__ __forceinline__ float silu_flush(float v) {
  const float y = v / (1.0f + expf(-v));
  return fabsf(y) < 1e-30f ? 0.0f : y;
}

union Pack8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

// SiLU of 8 accumulators (or zeros outside the domain) as 8 bf16, packed.
__device__ __forceinline__ uint4 silu8(const float* acc, bool in_domain) {
  Pack8 p;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = in_domain ? silu_flush(acc[2 * k]) : 0.0f;
    const float hi = in_domain ? silu_flush(acc[2 * k + 1]) : 0.0f;
    p.h[k] = __floats2bfloat162_rn(lo, hi);
  }
  return p.u;
}

// Into shared memory: four 4-byte stores (padded runs are 4-byte aligned).
__device__ __forceinline__ void store8_shared(bf16* dst, const float* acc,
                                              bool in_domain) {
  const uint4 v = silu8(acc, in_domain);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// One conv layer from a shared-memory tile: output (OH, OW, COUT) of a
// KxK/stride-S conv over the input tile `in` (element (y, x, c) at
// in[(y * IN_W + x) * IN_CS + c]), whose origin is placed so that output
// (oy, ox) reads input rows oy*S .. oy*S+K-1.  Weights are HWIO fp32
// (w[((ky*K + kx)*CIN + ci)*COUT + co]).  A work item is G consecutive
// output channels at PX positions NPG apart (so neighbouring threads take
// neighbouring positions); the epilogue gets each position's fp32 sums,
// bias included.
template <int K, int S, int CIN, int COUT, int OH, int OW, int IN_W,
          int IN_CS, class Epi>
__device__ __forceinline__ void conv_stage(const bf16* __restrict__ in,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           Epi epi) {
  static_assert(CIN % 2 == 0 && IN_CS % 2 == 0, "channel pairs");
  constexpr int NPOS = OH * OW;
  constexpr int NPG = (NPOS + PX - 1) / PX;
  constexpr int NITEMS = NPG * (COUT / G);
  for (int item = threadIdx.x; item < NITEMS; item += NTHREADS) {
    const int g = item / NPG;
    const int pg = item - g * NPG;
    int oy[PX], ox[PX];
    const bf16* ip[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int pos = min(pg + j * NPG, NPOS - 1);
      oy[j] = pos / OW;
      ox[j] = pos - oy[j] * OW;
      ip[j] = in + (oy[j] * S * IN_W + ox[j] * S) * IN_CS;
    }
    const float4* bp = reinterpret_cast<const float4*>(bias + g * G);
    const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
    float acc[PX][G];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      acc[j][0] = b0.x; acc[j][1] = b0.y; acc[j][2] = b0.z; acc[j][3] = b0.w;
      acc[j][4] = b1.x; acc[j][5] = b1.y; acc[j][6] = b1.z; acc[j][7] = b1.w;
    }
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int tap = (ky * IN_W + kx) * IN_CS;
        const float* wp = w + (ky * K + kx) * CIN * COUT + g * G;
#pragma unroll 2
        for (int ci = 0; ci < CIN; ci += 2) {
          const float4* w4 = reinterpret_cast<const float4*>(wp + ci * COUT);
          const float4 wa = __ldg(w4), wb = __ldg(w4 + 1);
          const float4 wc = __ldg(w4 + COUT / 4), wd = __ldg(w4 + COUT / 4 + 1);
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ip[j] + tap + ci));
            float* a = acc[j];
            a[0] = fmaf(v.x, wa.x, a[0]); a[1] = fmaf(v.x, wa.y, a[1]);
            a[2] = fmaf(v.x, wa.z, a[2]); a[3] = fmaf(v.x, wa.w, a[3]);
            a[4] = fmaf(v.x, wb.x, a[4]); a[5] = fmaf(v.x, wb.y, a[5]);
            a[6] = fmaf(v.x, wb.z, a[6]); a[7] = fmaf(v.x, wb.w, a[7]);
            a[0] = fmaf(v.y, wc.x, a[0]); a[1] = fmaf(v.y, wc.y, a[1]);
            a[2] = fmaf(v.y, wc.z, a[2]); a[3] = fmaf(v.y, wc.w, a[3]);
            a[4] = fmaf(v.y, wd.x, a[4]); a[5] = fmaf(v.y, wd.y, a[5]);
            a[6] = fmaf(v.y, wd.z, a[6]); a[7] = fmaf(v.y, wd.w, a[7]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < PX; ++j)
      if (pg + j * NPG < NPOS) epi(oy[j], ox[j], g * G, acc[j]);
  }
}

enum Stage : int { DMA = 0, STEM = 1, DOWN = 2, FULL = 3 };

// 8 bf16 from shared memory at a 4-byte aligned address.
__device__ __forceinline__ uint4 load8_shared(const bf16* src) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  return make_uint4(s[0], s[1], s[2], s[3]);
}

// The block's 8x16 output tile, written as 16-byte chunks: chunk q of
// position (oy, ox) holds channels 8q .. 8q+7 and is chunk(oy, ox, q).
// Neighbouring threads write neighbouring chunks.
template <class Chunk>
__device__ __forceinline__ void store_tile(bf16* __restrict__ out, int img,
                                           int r0, int c0, int H4, int W4,
                                           Chunk chunk) {
  for (int e = threadIdx.x; e < TH * TW * (C2 / 8); e += NTHREADS) {
    const int pos = e / (C2 / 8), q = e - pos * (C2 / 8);
    const int oy = pos / TW, ox = pos - oy * TW;
    *reinterpret_cast<uint4*>(
        out + (((size_t)img * H4 + r0 + oy) * W4 + c0 + ox) * C2 + q * 8) =
        chunk(oy, ox, q);
  }
}

template <int STAGE>
__global__ void __launch_bounds__(NTHREADS)
front_kernel(const bf16* __restrict__ x, int H, int W,
             const float* __restrict__ w0, const float* __restrict__ b0,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const float* __restrict__ w12, const float* __restrict__ b12,
             const float* __restrict__ wm1, const float* __restrict__ bm1,
             const float* __restrict__ wm2, const float* __restrict__ bm2,
             const float* __restrict__ w3, const float* __restrict__ b3,
             bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* region_a = reinterpret_cast<bf16*>(smem);
  bf16* region_b = region_a + A_ELEMS;
  const int img = blockIdx.z;
  const int r0 = blockIdx.y * TH;  // tile origin on the (H/4, W/4) grid
  const int c0 = blockIdx.x * TW;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;

  // 1. Space-to-depth input tile z, rows [2*r0-4, +ZH), cols [2*c0-4, +ZW):
  //    z[y][x][c*4 + i*2 + j] = frame[2y+i][2x+j][c], zero outside the frame
  //    (the stem's zero padding).  Threads walk the frame rows of the tile,
  //    so neighbouring threads read neighbouring addresses.
  {
    bf16* z = region_a;
    const int iy0 = 4 * r0 - 8, ix0 = 4 * c0 - 8;
    const bf16* frame = x + (size_t)img * H * W * 3;
    constexpr int ROW = 2 * ZW * 3;
    const bf16 zero = __float2bfloat16(0.0f);
    for (int e = threadIdx.x; e < 2 * ZH * ROW; e += NTHREADS) {
      const int ry = e / ROW;
      const int rem = e - ry * ROW;
      const int rx = rem / 3;
      const int c = rem - rx * 3;
      const int gy = iy0 + ry, gx = ix0 + rx;
      bf16 v = zero;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = frame[((size_t)gy * W + gx) * 3 + c];
      z[((ry >> 1) * ZW + (rx >> 1)) * C0 + c * 4 + (ry & 1) * 2 + (rx & 1)] =
          v;
    }
  }
  __syncthreads();
  if constexpr (STAGE == DMA) {
    // plane p = 2*rho + pi of position (oy, ox) is s2d position
    // (2*oy + rho, 2*ox + pi) of the tile origin (-4, -4): 12 channels
    // (chunk 2p: 0-7, chunk 2p+1: 8-11 and four zeros).
    const bf16* z = region_a;
    store_tile(out, img, r0, c0, H4, W4, [&](int oy, int ox, int q) {
      const int p = q >> 1;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          z + ((2 * oy + (p >> 1) + 4) * ZW + 2 * ox + (p & 1) + 4) * C0);
      return (q & 1) ? make_uint4(src[4], src[5], 0u, 0u)
                     : make_uint4(src[0], src[1], src[2], src[3]);
    });
    return;
  }

  // 2. Stem, rows [2*r0-3, +SH), cols [2*c0-3, +SW) of the (H/2, W/2) grid.
  {
    const int sy0 = 2 * r0 - 3, sx0 = 2 * c0 - 3;
    bf16* s = region_b;
    conv_stage<3, 1, C0, C1, SH, SW, ZW, C0>(
        region_a, w0, b0, [&](int oy, int ox, int co, const float* acc) {
          const int gy = sy0 + oy, gx = sx0 + ox;
          store8_shared(s + (oy * SW + ox) * CS1 + co, acc,
                        gy >= 0 && gy < H2 && gx >= 0 && gx < W2);
        });
  }
  __syncthreads();
  if constexpr (STAGE == STEM) {
    // stem rows 2*(r0+oy) and cols 2*(c0+ox) + half of the tile origin
    // (2*r0-3, 2*c0-3); chunks 0-3 the even column, 4-7 the odd one.
    const bf16* s = region_b;
    store_tile(out, img, r0, c0, H4, W4, [&](int oy, int ox, int q) {
      return load8_shared(
          s + ((2 * oy + 3) * SW + 2 * ox + 3 + (q >> 2)) * CS1 + (q & 3) * 8);
    });
    return;
  }

  // 3. Down, rows [r0-1, +DH), cols [c0-1, +DW) of the (H/4, W/4) grid.
  const int dy0 = r0 - 1, dx0 = c0 - 1;
  auto in_c3_domain = [&](int oy, int ox) {
    const int gy = dy0 + oy, gx = dx0 + ox;
    return gy >= 0 && gy < H4 && gx >= 0 && gx < W4;
  };
  bf16* d = region_a;
  conv_stage<3, 2, C1, C2, DH, DW, SW, CS1>(
      region_b, w1, b1, [&](int oy, int ox, int co, const float* acc) {
        store8_shared(d + (oy * DW + ox) * CS2 + co, acc,
                      in_c3_domain(oy, ox));
      });
  __syncthreads();
  if constexpr (STAGE == DOWN) {
    // the interior of the down tile, origin (r0-1, c0-1)
    store_tile(out, img, r0, c0, H4, W4, [&](int oy, int ox, int q) {
      return load8_shared(d + ((oy + 1) * DW + ox + 1) * CS2 + q * 8);
    });
    return;
  }

  // 4. C3 cv1 | cv2 as one 64->64 1x1 over the haloed down tile -> a.
  bf16* a = region_b;
  bf16* bb = region_b + DH * DW * CS2;
  conv_stage<1, 1, C2, C2, DH, DW, DW, CS2>(
      d, w12, b12, [&](int oy, int ox, int co, const float* acc) {
        store8_shared(a + (oy * DW + ox) * CS2 + co, acc,
                      in_c3_domain(oy, ox));
      });
  __syncthreads();

  // 5. m.cv1 1x1 on the cv1 half of a -> bb (zero outside the domain: the
  //    padding of m.cv2).
  conv_stage<1, 1, CM, CM, DH, DW, DW, CS2>(
      a, wm1, bm1, [&](int oy, int ox, int co, const float* acc) {
        store8_shared(bb + (oy * DW + ox) * CSM + co, acc,
                      in_c3_domain(oy, ox));
      });
  __syncthreads();

  // 6. m.cv2 3x3/p1 on bb over the interior, plus the shortcut: the bf16 sum
  //    m = bf16(silu) + cv1 replaces the cv1 half of a in place (each
  //    position and channel belongs to one thread, and no thread reads a
  //    here otherwise), so a's interior becomes cv3's input [m | cv2].
  conv_stage<3, 1, CM, CM, TH, TW, DW, CSM>(
      bb, wm2, bm2, [&](int oy, int ox, int co, const float* acc) {
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
            a + ((oy + 1) * DW + (ox + 1)) * CS2 + co);
        Pack8 c;
        c.u = silu8(acc, in_c3_domain(oy + 1, ox + 1));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 r = __bfloat1622float2(dst[k]);
          const float2 v = __bfloat1622float2(c.h[k]);
          dst[k] = __floats2bfloat162_rn(v.x + r.x, v.y + r.y);
        }
      });
  __syncthreads();

  // 7. cv3 1x1 64->64 on the interior of a -> the output tile.
  conv_stage<1, 1, C2, C2, TH, TW, DW, CS2>(
      a + (DW + 1) * CS2, w3, b3,
      [&](int oy, int ox, int co, const float* acc) {
        const int gy = r0 + oy, gx = c0 + ox;
        *reinterpret_cast<uint4*>(
            out + (((size_t)img * H4 + gy) * W4 + gx) * C2 + co) =
            silu8(acc, true);
      });
}

// One instance per stage, indexed by Stage.
typedef void (*FrontKernel)(const bf16*, int, int, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, bf16*);
constexpr FrontKernel kFrontKernels[] = {front_kernel<DMA>, front_kernel<STEM>,
                                         front_kernel<DOWN>, front_kernel<FULL>};

int launch_front(int stage, const void* x, const void* w0, const void* b0,
                 const void* w1, const void* b1, const void* w12,
                 const void* b12, const void* wm1, const void* bm1,
                 const void* wm2, const void* bm2, const void* w3,
                 const void* b3, void* out, int batch, int height, int width,
                 void* stream) {
  if (stage < DMA || stage > FULL || batch <= 0 || batch > 65535 ||
      height <= 0 || width <= 0 || height % 32 != 0 || width % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const FrontKernel kernel = kFrontKernels[stage];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(width / 4 / TW, height / 4 / TH, batch);
  kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, height, width, (const float*)w0, (const float*)b0,
      (const float*)w1, (const float*)b1, (const float*)w12,
      (const float*)b12, (const float*)wm1, (const float*)bm1,
      (const float*)wm2, (const float*)bm2, (const float*)w3,
      (const float*)b3, (bf16*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() after the launch
// (0 on success).  Pointers are device pointers: x (B, H, W, 3) bf16; the
// twelve fp32 weight/bias arrays in the layouts packed by
// lpr_tpu_torch.kernels.yolo_front.front_pack; out (B, H/4, W/4, 64) bf16.
extern "C" int lpr_yolo_front_bf16(
    const void* x, const void* w0, const void* b0, const void* w1,
    const void* b1, const void* w12, const void* b12, const void* wm1,
    const void* bm1, const void* wm2, const void* bm2, const void* w3,
    const void* b3, void* out, int batch, int height, int width,
    void* stream) {
  return launch_front(FULL, x, w0, b0, w1, b1, w12, b12, wm1, bm1, wm2, bm2,
                      w3, b3, out, batch, height, width, stream);
}

// Launches the stage variant `stage` (0 dma, 1 stem, 2 down, 3 full = K1)
// with lpr_yolo_front_bf16's arguments; cudaErrorInvalidValue for another
// stage.
extern "C" int lpr_yolo_front_stage_bf16(
    const void* x, const void* w0, const void* b0, const void* w1,
    const void* b1, const void* w12, const void* b12, const void* wm1,
    const void* bm1, const void* wm2, const void* bm2, const void* w3,
    const void* b3, void* out, int batch, int height, int width, int stage,
    void* stream) {
  return launch_front(stage, x, w0, b0, w1, b1, w12, b12, wm1, bm1, wm2, bm2,
                      w3, b3, out, batch, height, width, stream);
}

// Dynamic shared memory per block, for reports.
extern "C" int lpr_yolo_front_smem_bytes(void) { return SMEM_BYTES; }
