// K3 — the plate detector's layers 3-4 as one kernel, written by hand for
// Hopper (sm_90a), bound to Python through the plain C launcher at the
// bottom (lpr_tpu_torch/kernels/yolo_mid.py loads it with ctypes).
//
// Replaces the TPU kernel lpr_tpu/ops/pallas/yolo_mid.py:273 `mid_fused`
// (body `_mid_kernel`): yolov5s layers 3-4 with batch norm folded,
//   L3     3x3/s2/p1 conv 64->128 + SiLU
//   C3     cv1|cv2 1x1 128->64+64; two bottlenecks (m.cv1 1x1 64->64,
//          m.cv2 3x3/p1 64->64, residual add onto the running cv1 branch);
//          cv3 1x1 on [m | cv2] 128->128; SiLU after every conv (with the
//          |y| < 1e-30 -> 0 flush).
// Input: K1's output (B, H4, W4, 64) bf16 NHWC; output (B, H4/2, W4/2, 128)
// bf16 NHWC, layer 4's output (a saved head feature).  H4 and W4 even.  The
// TPU kernel's parity-plane repack of its input is TPU layout: this kernel
// reads K1's NHWC output directly.
//
// What bounds it: at 736x1280 one image needs 2.77 G multiply-adds against
// 7.5 MB of input and 3.8 MB of output (~490 FLOP per byte), so on this
// card it is bound by operations: ~5.6 us per image at the 989 TFLOP/s bf16
// tensor-core rate, ~3.4 us for the bytes alone.
//
// Design (the simple first version, K1's scheme one level down): one
// thread block per (image, 8x16 tile of the output grid).  The block stages
// its stride-2 input window (25x41x64) in shared memory and recomputes there
// the halo the two 3x3 bottleneck convs need (L3 and cv1|cv2 on 12x20, the
// first bottleneck on 10x18), so no intermediate goes to device memory.
// Intermediates are stored in bf16 and every sum is float32.  Every layer
// zeroes the positions of its tile outside the layer's domain (the zero
// padding of the next 3x3; the ragged last tile row, 92 = 11.5 x 8, is
// masked at the store).  Channel runs in shared memory are padded by one
// 4-byte word (odd word stride) so a warp's loads hit 32 banks.  Arithmetic
// is scalar fp32 FMA on the CUDA cores; tensor cores are later work.
// 197,712 B of shared memory: one block of 512 threads per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;            // output tile rows
constexpr int TW = 16;           // output tile cols
constexpr int LH = TH + 4;       // L3 / cv1|cv2 tile: 2-halo for two 3x3s
constexpr int LW = TW + 4;
constexpr int IH = 2 * LH + 1;   // stride-2 input window
constexpr int IW = 2 * LW + 1;
constexpr int CI = 64, CO = 128, CM = 64;
constexpr int NTHREADS = 512;
constexpr int G = 8;             // output channels per thread work item
constexpr int PX = 2;            // positions per thread work item
constexpr int CSI = CI + 2, CSO = CO + 2, CSM = CM + 2;   // odd word stride

// Region IN holds the input window, later Y (cv1 | cv2) and T (m.cv1);
// region A holds the L3 tile.
constexpr int IN_BYTES = ((IH * IW * CSI * 2) + 15) / 16 * 16;
constexpr int Y_ELEMS = LH * LW * CSO;
constexpr int T_ELEMS = LH * LW * CSM;
constexpr int A_ELEMS = LH * LW * CSO;
static_assert((Y_ELEMS + T_ELEMS) * 2 <= IN_BYTES, "Y and T must fit IN");
static_assert((Y_ELEMS * 2) % 16 == 0, "T must stay 16-byte aligned");
constexpr int SMEM_BYTES = IN_BYTES + A_ELEMS * 2;

__device__ __forceinline__ float silu_flush(float v) {
  const float y = v / (1.0f + expf(-v));
  return fabsf(y) < 1e-30f ? 0.0f : y;
}

union Pack8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

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

__device__ __forceinline__ void store8_shared(bf16* dst, const float* acc,
                                              bool in_domain) {
  const uint4 v = silu8(acc, in_domain);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// The residual add of a bottleneck: dst (bf16, 8 channels) becomes
// bf16(bf16(silu(acc)) + dst), or zero outside the domain.
__device__ __forceinline__ void add8_shared(bf16* dst, const float* acc,
                                            bool in_domain) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  Pack8 c;
  c.u = silu8(acc, in_domain);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 r = __bfloat1622float2(d[k]);
    const float2 v = __bfloat1622float2(c.h[k]);
    d[k] = in_domain ? __floats2bfloat162_rn(v.x + r.x, v.y + r.y)
                     : __floats2bfloat162_rn(0.0f, 0.0f);
  }
}

// One conv layer from a shared-memory tile (as in K1): output (OH, OW, COUT)
// of a KxK/stride-S conv over `in` (element (y, x, c) at
// in[(y * IN_W + x) * IN_CS + c]), output (oy, ox) reading input rows
// oy*S .. oy*S+K-1.  Weights HWIO fp32.  A work item is G output channels
// at PX positions NPG apart; epi gets each position's fp32 sums, bias
// included.
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

__global__ void __launch_bounds__(NTHREADS, 1)
mid_kernel(const bf16* __restrict__ x, int H4, int W4,
           const float* __restrict__ w3, const float* __restrict__ b3,
           const float* __restrict__ w12, const float* __restrict__ b12,
           const float* __restrict__ wa1, const float* __restrict__ ba1,
           const float* __restrict__ wa2, const float* __restrict__ ba2,
           const float* __restrict__ wb1, const float* __restrict__ bb1,
           const float* __restrict__ wb2, const float* __restrict__ bb2,
           const float* __restrict__ w3o, const float* __restrict__ b3o,
           bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* in_t = reinterpret_cast<bf16*>(smem);
  bf16* y = in_t;                   // after L3: cv1 | cv2 on the 12x20 tile
  bf16* t = in_t + Y_ELEMS;         // m.cv1 on the 12x20 tile
  bf16* a = reinterpret_cast<bf16*>(smem + IN_BYTES);   // L3 tile
  const int img = blockIdx.z;
  const int H8 = H4 / 2, W8 = W4 / 2;
  const int r0 = blockIdx.y * TH;   // tile origin on the output grid
  const int c0 = blockIdx.x * TW;
  const int ly0 = r0 - 2, lx0 = c0 - 2;   // 12x20 tile origin

  // 1. Input window rows [2*ly0-1, +IH), cols [2*lx0-1, +IW), zero outside
  //    the front grid (L3's zero padding); 16-byte global loads.
  {
    const int iy0 = 2 * ly0 - 1, ix0 = 2 * lx0 - 1;
    const bf16* src = x + (size_t)img * H4 * W4 * CI;
    for (int e = threadIdx.x; e < IH * IW * (CI / 8); e += NTHREADS) {
      const int v = e % (CI / 8);
      const int pos = e / (CI / 8);
      const int ry = pos / IW, rx = pos - ry * IW;
      const int gy = iy0 + ry, gx = ix0 + rx;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H4 && gx >= 0 && gx < W4)
        q = __ldg(reinterpret_cast<const uint4*>(
            src + ((size_t)gy * W4 + gx) * CI + v * 8));
      uint32_t* d = reinterpret_cast<uint32_t*>(in_t + pos * CSI + v * 8);
      d[0] = q.x;
      d[1] = q.y;
      d[2] = q.z;
      d[3] = q.w;
    }
  }
  __syncthreads();

  auto in_domain = [&](int oy, int ox) {   // position on the 12x20 tile
    const int gy = ly0 + oy, gx = lx0 + ox;
    return gy >= 0 && gy < H8 && gx >= 0 && gx < W8;
  };

  // 2. L3 3x3/s2 64->128 on the 12x20 tile -> a.
  conv_stage<3, 2, CI, CO, LH, LW, IW, CSI>(
      in_t, w3, b3, [&](int oy, int ox, int co, const float* acc) {
        store8_shared(a + (oy * LW + ox) * CSO + co, acc, in_domain(oy, ox));
      });
  __syncthreads();

  // 3. cv1 | cv2 as one 128->128 1x1 -> y (cv1 in channels 0-63).
  conv_stage<1, 1, CO, CO, LH, LW, LW, CSO>(
      a, w12, b12, [&](int oy, int ox, int co, const float* acc) {
        store8_shared(y + (oy * LW + ox) * CSO + co, acc, in_domain(oy, ox));
      });
  __syncthreads();

  // 4. Bottleneck 0: m.cv1 1x1 on the cv1 half over 12x20 -> t; m.cv2 3x3
  //    over the inner 10x18, added in place onto y's cv1 half.
  conv_stage<1, 1, CM, CM, LH, LW, LW, CSO>(
      y, wa1, ba1, [&](int oy, int ox, int co, const float* acc) {
        store8_shared(t + (oy * LW + ox) * CSM + co, acc, in_domain(oy, ox));
      });
  __syncthreads();
  conv_stage<3, 1, CM, CM, LH - 2, LW - 2, LW, CSM>(
      t, wa2, ba2, [&](int oy, int ox, int co, const float* acc) {
        add8_shared(y + ((oy + 1) * LW + ox + 1) * CSO + co, acc,
                    in_domain(oy + 1, ox + 1));
      });
  __syncthreads();

  // 5. Bottleneck 1: m.cv1 over the inner 10x18 -> t; m.cv2 over the
  //    central 8x16, added in place onto y.
  conv_stage<1, 1, CM, CM, LH - 2, LW - 2, LW, CSO>(
      y + (LW + 1) * CSO, wb1, bb1,
      [&](int oy, int ox, int co, const float* acc) {
        store8_shared(t + ((oy + 1) * LW + ox + 1) * CSM + co, acc,
                      in_domain(oy + 1, ox + 1));
      });
  __syncthreads();
  conv_stage<3, 1, CM, CM, TH, TW, LW, CSM>(
      t + (LW + 1) * CSM, wb2, bb2,
      [&](int oy, int ox, int co, const float* acc) {
        add8_shared(y + ((oy + 2) * LW + ox + 2) * CSO + co, acc,
                    in_domain(oy + 2, ox + 2));
      });
  __syncthreads();

  // 6. cv3 1x1 128->128 on [m | cv2] over the central 8x16 -> output.
  conv_stage<1, 1, CO, CO, TH, TW, LW, CSO>(
      y + (2 * LW + 2) * CSO, w3o, b3o,
      [&](int oy, int ox, int co, const float* acc) {
        const int gy = r0 + oy, gx = c0 + ox;
        if (gy < H8 && gx < W8)
          *reinterpret_cast<uint4*>(
              out + (((size_t)img * H8 + gy) * W8 + gx) * CO + co) =
              silu8(acc, true);
      });
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() after the launch
// (0 on success).  Pointers are device pointers: x (B, H4, W4, 64) bf16; the
// fourteen fp32 weight/bias arrays in the layouts packed by
// lpr_tpu_torch.kernels.yolo_mid.mid_pack; out (B, H4/2, W4/2, 128) bf16.
extern "C" int lpr_yolo_mid_bf16(
    const void* x, const void* w3, const void* b3, const void* w12,
    const void* b12, const void* wa1, const void* ba1, const void* wa2,
    const void* ba2, const void* wb1, const void* bb1, const void* wb2,
    const void* bb2, const void* w3o, const void* b3o, void* out, int batch,
    int h4, int w4, void* stream) {
  if (batch <= 0 || batch > 65535 || h4 <= 0 || w4 <= 0 || h4 % 2 != 0 ||
      w4 % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int h8 = h4 / 2, w8 = w4 / 2;
  const dim3 grid((w8 + TW - 1) / TW, (h8 + TH - 1) / TH, batch);
  mid_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, h4, w4, (const float*)w3, (const float*)b3,
      (const float*)w12, (const float*)b12, (const float*)wa1,
      (const float*)ba1, (const float*)wa2, (const float*)ba2,
      (const float*)wb1, (const float*)bb1, (const float*)wb2,
      (const float*)bb2, (const float*)w3o, (const float*)b3o, (bf16*)out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block, for reports.
extern "C" int lpr_yolo_mid_smem_bytes(void) { return SMEM_BYTES; }
