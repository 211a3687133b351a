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
// Input: letterboxed frames (B, H, W, 3) NHWC, bf16 (normalised) or uint8
// (raw bytes, with 1/255 folded into the stem weights: the TPU kernel's
// `is_u8` mode); output (B, H/4, W/4, 64) bf16 NHWC.  H % 32 == 0 and
// W % 64 == 0 (whole output tiles).
//
// What bounds it: at 736x1280 one image needs 2.98 G multiply-adds against
// 5.65 MB of input (2.83 MB as uint8) and 7.54 MB of output (~450 FLOP per
// byte), so on this card it is compute-bound: ~6.0 us per image at the
// 989 TFLOP/s bf16 tensor-core rate, ~3.9 us (uint8: ~3.1 us) for the
// bytes alone.
//
// Design.  One thread block of 8 warps per (image, 8x16 tile of the
// H/4 x W/4 output grid), two blocks an SM.  The block recomputes in shared
// memory the halo each later layer needs, so no intermediate activation
// goes to device memory (what the TPU kernel keeps in VMEM):
//   z     space-to-depth input  23 x 39  (ZH x ZW)   28.0 KB
//   stem                        21 x 37  (SH x SW)   52.3 KB (parity planes)
//   down                        10 x 18  (DH x DW)   22.5 KB
//   a = cv1|cv2, bb = m.cv1     10 x 18              22.5 + 11.3 KB
//   m.cv2, cv3                   8 x 16  (TH x TW)   in place / to the output
// Halo arithmetic per tile: the stem computes 777 positions for 512 useful
// ones (1.52x), the down conv and the C3's 1x1s 180 for 128 (1.41x); with M
// padded to whole m16 tiles and the stem's K to 16 channels a tap, a block
// issues 4,804 mma.m16n8k16 (stem 1,764, down 1,728, cv1|cv2 384, m.cv1
// 96, m.cv2 576, cv3 256): 9.84 M multiply-adds for 6.48 M exact ones.
// The tile is the largest that every H % 32 == 0, W % 64 == 0 takes, and
// a 16x16 one would need 141 KB, one block an SM.  A block that walked
// down a column band, keeping the last rows of each layer, would drop the
// vertical halo: doing only that work takes 0.325 against 0.365 ms
// (lpr_tpu_torch/tools/front_variants.py `no_vertical_halo`), an 11 %
// ceiling before its row copies and band starts, so the tile stays.
//
// Every convolution is an implicit GEMM on the tensor cores (conv_mma, in
// csrc/implicit_gemm.cuh with the epilogue helpers; K3 shares it):
// M = the layer's tile positions (padded to 16 with clamped rows, which
// repeat the last position), N = output channels, K = taps x 16-channel
// chunks; mma.sync m16n8k16 bf16 in, float32 accumulators that start from
// the bias.  Tiles live in shared memory as bf16 in csrc/mma_conv.cuh's layout:
// 16 channels of a position in one 32-byte row, the 16-byte halves
// XOR-swizzled, one plane of rows per 16-channel chunk; every lane
// addresses its own ldmatrix row, so a tap of any conv is a shift of row
// indices and needs no gather.  The stride-2 down conv would read rows two
// apart, which the swizzle puts two to a bank group; so the stem tile is
// stored as four row/column parity planes (the TPU kernel's own layout
// idea), in which a stride-2 tap reads consecutive rows of one plane and
// ldmatrix stays conflict-free.  The weights are bf16 B fragments in
// fragment order (front_pack): a lane reads its b0/b1 words for two n-tiles
// as one 16-byte __ldg, from L1/L2, which every block shares.  Staged in
// shared memory (83 KB more, so one block an SM) they made K1 0.466
// against 0.365 ms (tools/front_variants.py `weights_in_smem`).
//
// The epilogue rounds where the scalar kernel and the TPU kernel round:
// SiLU in float32 with the flush, zero outside the layer's domain (which
// is the zero padding the next conv reads), one bf16 store; the m.cv2
// residual as one bf16 sum onto cv1; cv3 straight to the output.  At
// ~66 k SiLUs a block the epilogue weighs as much as the MMAs, so SiLU
// runs on the SFU's approximations (silu_flush) and the epilogue has no
// branch (conv_mma, silu2): 0.592 ms without either, 0.365 with both.
//
// Input staging: the frame rows of the tile arrive with 16-byte cp.async
// (the zero-fill form outside the frame) and are rearranged into z, whose
// 16 channels per position are the 12 bytes of frame row 2y (pixels 2x,
// 2x+1), the 12 of row 2y+1, and 4 zeros: kernel channel i*6 + j*3 + c
// holds space-to-depth channel c*4 + i*2 + j, and front_pack orders the
// stem's B rows to match (values move, none is rounded).
//
// The uint8 input (the input type is a template parameter beside the
// stage) halves the bytes the kernel reads: 3 a pixel, so a tile's first
// byte 12*c0 - 24 lies 8 bytes past a 16-byte boundary (at 6 a pixel it
// happened to fall on one).  The staged window is widened to whole
// aligned chunks, from byte 12*c0 - 32 (16 chunks, 256 bytes a row where
// 242 are used), and z indexes 8 bytes into it; each byte becomes a bf16
// exactly (0..255 needs 8 significant bits) while z is built.  The stem
// then multiplies bf16(u8) by bf16(w0 / 255), where the TPU kernel casts
// its uint8 window to bf16 the same way (yolo_front.py `xwc`).  Everything
// after z is the bf16 instance's code.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "implicit_gemm.cuh"

namespace {

using namespace mma_conv;
using namespace implicit_gemm;
typedef __nv_bfloat16 bf16;

constexpr int TH = 8;           // output tile rows (H/4 grid)
constexpr int TW = 16;          // output tile cols (W/4 grid)
constexpr int DH = TH + 2;      // down tile with the 1-halo of m.cv2's 3x3
constexpr int DW = TW + 2;
constexpr int SH = 2 * DH + 1;  // stem tile read by the down tile's 3x3/s2
constexpr int SW = 2 * DW + 1;
constexpr int ZH = SH + 2;      // space-to-depth tile read by the stem's 3x3
constexpr int ZW = SW + 2;
constexpr int PH = (SH + 1) / 2;  // a stem parity plane: 11 x 19 positions
constexpr int PW = (SW + 1) / 2;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

// Positions (32-byte rows) of one 16-channel chunk plane of each tile.
constexpr int ZP = ZH * ZW;          // 897
constexpr int SP = 4 * PH * PW;      // 836: stem, parity planes 2*rho + pi
constexpr int DP = DH * DW;          // 180
constexpr int OP = TH * TW;          // 128

// Frame rows [4*r0 - 8, +2*ZH), pixels [4*c0 - 8, +2*ZW): 468 bytes a row,
// staged as 30 16-byte chunks (the offset 24*c0 - 48 is 16-byte aligned and
// W*6 a multiple of 16, so a chunk lies wholly inside or outside the row).
constexpr int FR_ROWS = 2 * ZH;
constexpr int FR_CHUNKS = (2 * ZW * 3 * 2 + 15) / 16;
constexpr int FR_STRIDE = FR_CHUNKS * 16;
// uint8 frames: 234 bytes a row from byte 12*c0 - 24, staged from the
// 16-byte boundary 8 bytes before it (W*3 is a multiple of 16 too).
constexpr int U8_SKIP = 8;
constexpr int U8_CHUNKS = (U8_SKIP + 2 * ZW * 3 + 15) / 16;
constexpr int U8_STRIDE = U8_CHUNKS * 16;

// Region A holds z, later the down tile; region B the staged frame rows,
// then the stem planes, then a (4 chunks) and bb (2 chunks).
constexpr int Z_BYTES = ZP * 32;
constexpr int D_BYTES = 4 * DP * 32;
constexpr int REGION_A = Z_BYTES > D_BYTES ? Z_BYTES : D_BYTES;
constexpr int REGION_B = 2 * SP * 32;
static_assert(FR_ROWS * FR_STRIDE <= REGION_B, "frame rows fit region B");
static_assert(FR_ROWS * U8_STRIDE <= REGION_B, "uint8 rows fit region B");
static_assert(6 * DP * 32 <= REGION_B, "a and bb fit region B");
static_assert(REGION_A % 16 == 0, "region B stays 16-byte aligned");
constexpr int SMEM_BYTES = REGION_A + REGION_B;

// The B fragments of each layer (front_pack's order: k-step, n-tile pair,
// lane, 16 bytes), in uint4 units, and the biases, in floats.
constexpr int frag_len(int ksteps, int n) { return ksteps * (n / 16) * 32; }
constexpr int F_STEM = 0;
constexpr int F_DOWN = F_STEM + frag_len(9, 32);
constexpr int F_C12 = F_DOWN + frag_len(18, 64);
constexpr int F_M1 = F_C12 + frag_len(4, 64);
constexpr int F_M2 = F_M1 + frag_len(2, 32);
constexpr int F_C3 = F_M2 + frag_len(18, 32);
constexpr int F_END = F_C3 + frag_len(4, 64);
constexpr int B_STEM = 0, B_DOWN = 32, B_C12 = 96, B_M1 = 160, B_M2 = 192,
              B_C3 = 224, B_END = 288;

enum Stage : int { DMA = 0, STEM = 1, DOWN = 2, FULL = 3 };

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// The block's 8x16 output tile, written as 16-byte chunks: chunk q of
// position (oy, ox) holds channels 8q .. 8q+7 and is chunk(oy, ox, q).
// Neighbouring threads write neighbouring chunks.
template <class Chunk>
__device__ __forceinline__ void store_tile(bf16* __restrict__ out, int img,
                                           int r0, int c0, int H4, int W4,
                                           Chunk chunk) {
  for (int e = threadIdx.x; e < OP * 8; e += NTHREADS) {
    const int pos = e >> 3, q = e & 7;
    const int oy = pos / TW, ox = pos - oy * TW;
    *reinterpret_cast<uint4*>(
        out + (((size_t)img * H4 + r0 + oy) * W4 + c0 + ox) * 64 + q * 8) =
        chunk(oy, ox, q);
  }
}

// Two bytes of the staged uint8 window as a bf16 pair (low half first),
// exactly.
__device__ __forceinline__ uint32_t u8x2_bf16(const unsigned char* p) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)p[0], (float)p[1]);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int STAGE, class In>
__global__ void __launch_bounds__(NTHREADS, 2)
front_kernel(const In* __restrict__ x, int H, int W,
             const uint4* __restrict__ wf, const float* __restrict__ bias,
             bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const ra = smem;             // z, then the down tile d
  unsigned char* const rb = smem + REGION_A;  // frame rows, stem, a | bb
  const uint32_t sa = smem_u32(ra), sb = smem_u32(rb);
  const int img = blockIdx.z;
  const int r0 = blockIdx.y * TH;  // tile origin on the (H/4, W/4) grid
  const int c0 = blockIdx.x * TW;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;

  // 1. Space-to-depth input tile z, rows [2*r0-4, +ZH), cols [2*c0-4, +ZW).
  //    The frame rows arrive in region B with 16-byte cp.async (zeros
  //    outside the frame: the stem's padding), then each thread builds the
  //    32-byte rows of its positions from two 12-byte runs (bf16), or from
  //    two 6-byte runs converted to bf16 (uint8).
  if constexpr (sizeof(In) == 2) {
    const unsigned char* frame =
        reinterpret_cast<const unsigned char*>(x) + (size_t)img * H * W * 6;
    const int fy0 = 4 * r0 - 8, bx0 = (4 * c0 - 8) * 6, row_bytes = W * 6;
    for (int e = threadIdx.x; e < FR_ROWS * FR_CHUNKS; e += NTHREADS) {
      const int fr = e / FR_CHUNKS, k = e - fr * FR_CHUNKS;
      const int gy = fy0 + fr, bx = bx0 + 16 * k;
      const bool valid = gy >= 0 && gy < H && bx >= 0 && bx + 16 <= row_bytes;
      cp_async16(sb + fr * FR_STRIDE + 16 * k,
                 valid ? frame + (size_t)gy * row_bytes + bx : frame, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int q = threadIdx.x; q < ZP; q += NTHREADS) {
      const int zy = q / ZW, zx = q - zy * ZW;
      const uint32_t* f0 = reinterpret_cast<const uint32_t*>(
          rb + 2 * zy * FR_STRIDE + 12 * zx);
      const uint32_t* f1 = f0 + FR_STRIDE / 4;
      *reinterpret_cast<uint4*>(ra + swz(q, 0)) =
          make_uint4(f0[0], f0[1], f0[2], f1[0]);
      *reinterpret_cast<uint4*>(ra + swz(q, 1)) =
          make_uint4(f1[1], f1[2], 0u, 0u);
    }
  } else {
    const unsigned char* frame =
        reinterpret_cast<const unsigned char*>(x) + (size_t)img * H * W * 3;
    const int fy0 = 4 * r0 - 8, bx0 = 12 * c0 - 24 - U8_SKIP,
              row_bytes = W * 3;
    for (int e = threadIdx.x; e < FR_ROWS * U8_CHUNKS; e += NTHREADS) {
      const int fr = e / U8_CHUNKS, k = e - fr * U8_CHUNKS;
      const int gy = fy0 + fr, bx = bx0 + 16 * k;
      const bool valid = gy >= 0 && gy < H && bx >= 0 && bx + 16 <= row_bytes;
      cp_async16(sb + fr * U8_STRIDE + 16 * k,
                 valid ? frame + (size_t)gy * row_bytes + bx : frame, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int q = threadIdx.x; q < ZP; q += NTHREADS) {
      const int zy = q / ZW, zx = q - zy * ZW;
      const unsigned char* f0 = rb + 2 * zy * U8_STRIDE + U8_SKIP + 6 * zx;
      const unsigned char* f1 = f0 + U8_STRIDE;
      *reinterpret_cast<uint4*>(ra + swz(q, 0)) =
          make_uint4(u8x2_bf16(f0), u8x2_bf16(f0 + 2), u8x2_bf16(f0 + 4),
                     u8x2_bf16(f1));
      *reinterpret_cast<uint4*>(ra + swz(q, 1)) =
          make_uint4(u8x2_bf16(f1 + 2), u8x2_bf16(f1 + 4), 0u, 0u);
    }
  }
  __syncthreads();
  if constexpr (STAGE == DMA) {
    // plane p = 2*rho + pi of position (oy, ox) is z position
    // (2*oy + rho + 4, 2*ox + pi + 4); s2d channel k = c*4 + i*2 + j sits
    // in kernel channel i*6 + j*3 + c.
    store_tile(out, img, r0, c0, H4, W4, [&](int oy, int ox, int q) {
      const int p = q >> 1;
      const int zq = (2 * oy + (p >> 1) + 4) * ZW + 2 * ox + (p & 1) + 4;
      Pack8 v;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = (q & 1) * 8 + e;
        const int kc = ((k >> 1) & 1) * 6 + (k & 1) * 3 + (k >> 2);
        v.h[e] = k < 12 ? *reinterpret_cast<const bf16*>(
                              ra + swz(zq, kc >> 3) + (kc & 7) * 2)
                        : __float2bfloat16(0.0f);
      }
      return v.u;
    });
    return;
  }

  // 2. Stem, rows [2*r0-3, +SH), cols [2*c0-3, +SW) of the (H/2, W/2) grid,
  //    over z in natural order; stored as parity planes: stem position
  //    (sy, sx) is row ((2*(sy&1) + (sx&1))*PH + sy/2)*PW + sx/2.
  {
    const int sy0 = 2 * r0 - 3, sx0 = 2 * c0 - 3;
    conv_mma<NWARPS, SH * SW, 32, 9, 2, 4>(
        sa, wf + F_STEM, bias + B_STEM,
        [](int p) {
          const int sy = p / SW;
          return sy * ZW + (p - sy * SW);
        },
        [](int s) { return (s / 3) * ZW + s % 3; },
        [&](int p, int co, float v0, float v1) {
          const int sy = p / SW, sx = p - sy * SW;
          const bool in = (unsigned)(sy0 + sy) < (unsigned)H2 &&
                          (unsigned)(sx0 + sx) < (unsigned)W2;
          const int pos =
              ((2 * (sy & 1) + (sx & 1)) * PH + (sy >> 1)) * PW + (sx >> 1);
          *reinterpret_cast<uint32_t*>(rb + pair_off(SP, pos, co)) =
              silu2(v0, v1, in);
        });
  }
  __syncthreads();
  if constexpr (STAGE == STEM) {
    // stem rows 2*(r0+oy) and cols 2*(c0+ox) + half of the tile origin
    // (2*r0-3, 2*c0-3): local (2*oy+3, 2*ox+3+half), odd row plane; chunks
    // 0-3 the even column (odd plane, x/2 = ox+1), 4-7 the odd one (even
    // plane, x/2 = ox+2).
    store_tile(out, img, r0, c0, H4, W4, [&](int oy, int ox, int q) {
      const int half = q >> 2, c = q & 3;
      const int pos = ((2 + 1 - half) * PH + oy + 1) * PW + ox + 1 + half;
      return *reinterpret_cast<const uint4*>(
          rb + swz((c >> 1) * SP + pos, c & 1));
    });
    return;
  }

  // 3. Down, rows [r0-1, +DH), cols [c0-1, +DW) of the (H/4, W/4) grid;
  //    tap (ky, kx) of position (oy, ox) reads stem (2*oy+ky, 2*ox+kx):
  //    plane (ky&1, kx&1), row oy + ky/2, col ox + kx/2.  k-step 2*tap + c.
  const int dy0 = r0 - 1, dx0 = c0 - 1;
  auto in_c3_domain = [&](int p) {
    const int oy = p / DW, ox = p - oy * DW;
    return (unsigned)(dy0 + oy) < (unsigned)H4 &&
           (unsigned)(dx0 + ox) < (unsigned)W4;
  };
  conv_mma<NWARPS, DP, 64, 18, 3, 4>(
      sb, wf + F_DOWN, bias + B_DOWN,
      [](int p) {
        const int oy = p / DW;
        return oy * PW + (p - oy * DW);
      },
      [](int s) {
        const int t = s >> 1, ky = t / 3, kx = t % 3;
        return (s & 1) * SP + (2 * (ky & 1) + (kx & 1)) * PH * PW +
               (ky >> 1) * PW + (kx >> 1);
      },
      [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(ra + pair_off(DP, p, co)) =
            silu2(v0, v1, in_c3_domain(p));
      });
  __syncthreads();
  if constexpr (STAGE == DOWN) {
    // the interior of the down tile, origin (r0-1, c0-1)
    store_tile(out, img, r0, c0, H4, W4, [&](int oy, int ox, int q) {
      return *reinterpret_cast<const uint4*>(
          ra + swz((q >> 1) * DP + (oy + 1) * DW + ox + 1, q & 1));
    });
    return;
  }

  // 4. C3 cv1 | cv2 as one 64->64 1x1 over the haloed down tile -> a.
  unsigned char* const a = rb;
  unsigned char* const bb = rb + 4 * DP * 32;
  conv_mma<NWARPS, DP, 64, 4, 3, 4>(
      sa, wf + F_C12, bias + B_C12, [](int p) { return p; },
      [](int s) { return s * DP; },
      [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(a + pair_off(DP, p, co)) =
            silu2(v0, v1, in_c3_domain(p));
      });
  __syncthreads();

  // 5. m.cv1 1x1 on the cv1 half of a (chunks 0-1) -> bb (zero outside the
  //    domain: the padding of m.cv2).
  conv_mma<NWARPS, DP, 32, 2, 3, 2>(
      sb, wf + F_M1, bias + B_M1, [](int p) { return p; },
      [](int s) { return s * DP; },
      [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(bb + pair_off(DP, p, co)) =
            silu2(v0, v1, in_c3_domain(p));
      });
  __syncthreads();

  // 6. m.cv2 3x3/p1 on bb over the interior (every interior position of a
  //    whole tile is in the domain), plus the shortcut: the bf16 sum
  //    m = bf16(silu) + cv1 replaces the cv1 half of a in place (each
  //    position and channel pair belongs to one lane, and nothing reads a
  //    here otherwise), so a's interior becomes cv3's input [m | cv2].
  static_assert(OP % 16 == 0, "no padding row adds the shortcut twice");
  conv_mma<NWARPS, OP, 32, 18, 1, 4>(
      smem_u32(bb), wf + F_M2, bias + B_M2,
      [](int p) { return (p >> 4) * DW + (p & 15); },
      [](int s) {
        const int t = s >> 1;
        return (s & 1) * DP + (t / 3) * DW + t % 3;
      },
      [&](int p, int co, float v0, float v1) {
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
            a + pair_off(DP, ((p >> 4) + 1) * DW + (p & 15) + 1, co));
        const float2 r = __bfloat1622float2(*dst);
        const float2 m = __bfloat1622float2(
            __floats2bfloat162_rn(silu_flush(v0), silu_flush(v1)));
        *dst = __floats2bfloat162_rn(m.x + r.x, m.y + r.y);
      });
  __syncthreads();

  // 7. cv3 1x1 64->64 on the interior of a -> the output tile.
  bf16* const o = out + ((size_t)img * H4 + r0) * W4 * 64 + (size_t)c0 * 64;
  conv_mma<NWARPS, OP, 64, 4, 1, 8>(
      sb, wf + F_C3, bias + B_C3,
      [](int p) { return ((p >> 4) + 1) * DW + (p & 15) + 1; },
      [](int s) { return s * DP; },
      [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(
            o + ((size_t)(p >> 4) * W4 + (p & 15)) * 64 + co) =
            pack2(silu_flush(v0), silu_flush(v1));
      });
}

// One bf16 instance per stage, indexed by Stage, and K1's uint8 instance.
template <class In>
using FrontKernel = void (*)(const In*, int, int, const uint4*, const float*,
                             bf16*);
constexpr FrontKernel<bf16> kFrontKernels[] = {
    front_kernel<DMA, bf16>, front_kernel<STEM, bf16>,
    front_kernel<DOWN, bf16>, front_kernel<FULL, bf16>};

template <class In>
int launch_front(FrontKernel<In> kernel, const void* x, const void* wmma,
                 const void* bias, void* out, int batch, int height,
                 int width, void* stream) {
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 ||
      height % 32 != 0 || width % 64 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wmma) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bias) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(width / 4 / TW, height / 4 / TH, batch);
  kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const In*)x, height, width, (const uint4*)wmma, (const float*)bias,
      (bf16*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() after the launch
// (0 on success).  Pointers are device pointers: x (B, H, W, 3) bf16;
// wmma the six layers' bf16 B fragments and bias their 288 fp32 biases, as
// lpr_tpu_torch.kernels.yolo_front.front_pack packs them ("mma", "bias");
// out (B, H/4, W/4, 64) bf16.
extern "C" int lpr_yolo_front_bf16(const void* x, const void* wmma,
                                   const void* bias, void* out, int batch,
                                   int height, int width, void* stream) {
  return launch_front<bf16>(kFrontKernels[FULL], x, wmma, bias, out, batch,
                            height, width, stream);
}

// Launches K1's uint8 instance with lpr_yolo_front_bf16's arguments, but x
// (B, H, W, 3) uint8 (16-byte aligned) and the stem of the pack scaled by
// 1/255 (front_pack(model, input_scale=1/255)).
extern "C" int lpr_yolo_front_u8(const void* x, const void* wmma,
                                 const void* bias, void* out, int batch,
                                 int height, int width, void* stream) {
  return launch_front<uint8_t>(front_kernel<FULL, uint8_t>, x, wmma, bias,
                               out, batch, height, width, stream);
}

// Launches the stage variant `stage` (0 dma, 1 stem, 2 down, 3 full = K1)
// with lpr_yolo_front_bf16's arguments; cudaErrorInvalidValue for another
// stage.
extern "C" int lpr_yolo_front_stage_bf16(const void* x, const void* wmma,
                                         const void* bias, void* out,
                                         int batch, int height, int width,
                                         int stage, void* stream) {
  if (stage < DMA || stage > FULL) return (int)cudaErrorInvalidValue;
  return launch_front<bf16>(kFrontKernels[stage], x, wmma, bias, out, batch,
                            height, width, stream);
}

// Dynamic shared memory per block, for reports.
extern "C" int lpr_yolo_front_smem_bytes(void) { return SMEM_BYTES; }
// Elements of the packed B fragments (bf16) and biases (fp32) it reads.
extern "C" int lpr_yolo_front_mma_elems(void) { return F_END * 8; }
extern "C" int lpr_yolo_front_bias_elems(void) { return B_END; }
