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
// bf16 NHWC, layer 4's output (a saved head feature).  H4 and W4 even; a
// ragged last tile row or column is masked at the store.
//
// What bounds it: at 736x1280 one image needs 2.77 G multiply-adds against
// 7.5 MB of input and 3.8 MB of output (~490 FLOP per byte), so on this
// card it is bound by operations: ~5.6 us per image at the 989 TFLOP/s bf16
// tensor-core rate, ~3.4 us for the bytes alone.  The design therefore puts
// every multiply-add on the tensor cores and keeps every intermediate out
// of device memory, which costs a halo: 18,208 mma.m16n8k16 a block with
// M padded to whole m16 tiles (37.3 M multiply-adds for 24.1 M exact ones,
// 1.55x); with the warp tiles below a block runs 18,944 (38.8 M, 1.61x).
//
// Design (K1's scheme one level down, csrc/yolo_front.cu).  One block of 16
// warps per (image, 8x16 tile of the output grid), one block an SM.  The
// block recomputes in shared memory the halo that the two bottleneck 3x3s
// need, every tile bf16 in csrc/mma_conv.cuh's layout (16 channels of a
// position in one swizzled 32-byte row, one plane of rows per chunk):
//   in    input window 25 x 41 x 64 as four row/column parity planes of
//         13 x 21 (IH x IW, PH x PW)                              139,776 B
//   a     L3 on 12 x 20 (LH x LW), 128 channels                    61,440 B
//   y     cv1 | cv2 on 12 x 20, in `in`'s place                    61,440 B
//   t     m.cv1 of each bottleneck, 64 channels, after y           30,720 B
//   m0    bottleneck 0's sum on the inner 10 x 18, in a's place
//   m1    bottleneck 1's sum on the central 8 x 16, in y's cv1 half
// 201,216 B in all.  Every convolution is an implicit GEMM on the tensor
// cores through conv_mma (csrc/implicit_gemm.cuh, shared with K1): M = the
// layer's tile positions (padded to 16 with clamped rows), N = output
// channels, K = taps x 16-channel chunks, mma.sync m16n8k16 bf16 in,
// float32 accumulators from the bias; a tap is a shift of row indices.
// The input window arrives with 16-byte cp.async (the zero-fill form
// outside the front grid is L3's padding) straight into the parity planes,
// so L3's stride-2 taps read consecutive rows of one plane and ldmatrix
// stays conflict-free, as K1's down conv does.
//
// Per block (k-steps of 16 channels; warp tile MT m-tiles x NTW n-tiles,
// 16 units a layer, one per warp):
//   L3       M 240   N 128   36 k-steps   2 x 8   9,216 mma (16 padded)
//   cv1|cv2  M 240   N 128    8           4 x 4   2,048
//   b0 m.cv1 M 240   N  64    4           2 x 4     512
//   b0 m.cv2 M 180   N  64   36           3 x 2   3,456
//   b1 m.cv1 M 180   N  64    4           3 x 2     384
//   b1 m.cv2 M 128   N  64   36           2 x 2   2,304
//   cv3      M 128   N 128    8           2 x 4   1,024
// The 16 x 32 threads' registers cap a thread at 128: nvcc gives
// mid_kernel 128 and no spills.  L3's 2 x 8 tile beat 4 x 4 by 0.5-1.3 %
// in three calls and 8 x 2 by 4-8 %; the other layers' alternatives came
// within 2 % (lpr_tpu_torch/tools/front_variants.py --kernel mid).
//
// The B operand.  The weights are 188,416 bf16 (368 KB) of B fragments in
// fragment order (mid_pack), read per warp with __ldg as K1 reads its own:
// a lane reads its b0/b1 words of two n-tiles as one 16-byte load.  With
// the warp tiles above a block's warps read 2.13 MB of fragments through
// L1 (each fragment once per m-group: L3's eight times), of which 368 KB
// are distinct; warps of one n-group read the same fragments at about the
// same k-step, so L1 serves most repeats and L2 the rest.  That traffic
// costs 8-13 %: with every k-step reading k-step 0's fragments, which stay
// in L1, the kernel is that much faster (front_variants `b_kstep0`, wrong
// outputs).  The other route, a ring of k-step slices in shared
// memory loaded with cp.async and read by all warps in lockstep (L2
// traffic 368 KB a block, one barrier a k-step; conv_mma's RING,
// B_RING below), is 19-24 % slower: the 132 barriers a block cost more
// than the L2 traffic they save (`b_ring4`, `b_ring6`).
//
// Epilogue as in K1: SiLU on the SFU (silu_flush), zero outside the
// layer's domain by a select (the zero padding the next 3x3 reads), one
// bf16 store; clamped padding rows rewrite their twin's value.  Both
// residual sums (m = bf16(silu) + running cv1, one rounding) are written
// to another buffer than the one they read (m0 into a, m1 into y), so the
// clamped rows of b0's m.cv2 (M = 180, not a multiple of 16) write the
// same sum again instead of adding the shortcut twice.  cv3 stores
// straight to the output, masked to the front grid's own output rows and
// columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "implicit_gemm.cuh"

namespace {

using namespace mma_conv;
using namespace implicit_gemm;
typedef __nv_bfloat16 bf16;

constexpr int TH = 8;            // output tile rows
constexpr int TW = 16;           // output tile cols
constexpr int LH = TH + 4;       // L3 / cv1|cv2 tile: 2-halo for two 3x3s
constexpr int LW = TW + 4;
constexpr int IH = 2 * LH + 1;   // stride-2 input window
constexpr int IW = 2 * LW + 1;
constexpr int PH = (IH + 1) / 2;  // an input parity plane: 13 x 21
constexpr int PW = (IW + 1) / 2;
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;

// Positions (32-byte rows) of one 16-channel chunk plane of each tile.
constexpr int IP = 4 * PH * PW;             // 1,092: input, planes 2*rho+pi
constexpr int LP = LH * LW;                 // 240: a, y, t, m0
constexpr int BP = (LH - 2) * (LW - 2);     // 180: the inner 10 x 18
constexpr int OP = TH * TW;                 // 128: the central 8 x 16

constexpr int IN_BYTES = 4 * IP * 32;
constexpr int A_BYTES = 8 * LP * 32;
constexpr int Y_BYTES = 8 * LP * 32;
constexpr int T_BYTES = 4 * LP * 32;
static_assert(Y_BYTES + T_BYTES <= IN_BYTES, "y and t fit the input region");
// The B route (conv_mma's RING, csrc/implicit_gemm.cuh): 0 reads the
// fragments with __ldg; n >= 2 stages them in a ring of n k-step slices
// of up to 4 KB after region a.
constexpr int B_RING = 0;
constexpr int SMEM_BYTES = IN_BYTES + A_BYTES + B_RING * 128 * 32;

// The B fragments of each layer (mid_pack's order: k-step, n-tile pair,
// lane, 16 bytes), in uint4 units, and the biases, in floats.
constexpr int frag_len(int ksteps, int n) { return ksteps * (n / 16) * 32; }
constexpr int F_L3 = 0;
constexpr int F_C12 = F_L3 + frag_len(36, 128);
constexpr int F_A1 = F_C12 + frag_len(8, 128);
constexpr int F_A2 = F_A1 + frag_len(4, 64);
constexpr int F_B1 = F_A2 + frag_len(36, 64);
constexpr int F_B2 = F_B1 + frag_len(4, 64);
constexpr int F_C3 = F_B2 + frag_len(36, 64);
constexpr int F_END = F_C3 + frag_len(8, 128);
constexpr int B_L3 = 0, B_C12 = 128, B_A1 = 256, B_A2 = 320, B_B1 = 384,
              B_B2 = 448, B_C3 = 512, B_END = 640;

// Row of the 12 x 20 tile of position p of its inner 10 x 18 and of its
// central 8 x 16.
__device__ __forceinline__ int inner_row(int p) {
  const int oy = p / (LW - 2);
  return (oy + 1) * LW + (p - oy * (LW - 2)) + 1;
}
__device__ __forceinline__ int central_row(int p) {
  return ((p >> 4) + 2) * LW + (p & 15) + 2;
}

// k-step s = 4 * tap + chunk of a 3x3/p1 conv over a 12 x 20 tile: the
// tap's shift from the window's top-left row, in the chunk's plane.
__device__ __forceinline__ int tap3x3(int s) {
  const int t = s >> 2;
  return (s & 3) * LP + (t / 3) * LW + t % 3;
}

// The bottleneck sum of a channel pair: bf16(bf16(silu(v)) + r), r the
// bf16 pair at `res`, or zeros outside the domain.
__device__ __forceinline__ uint32_t residual2(float v0, float v1,
                                              const unsigned char* res,
                                              bool in_domain) {
  const float2 r =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res));
  const float2 m = __bfloat1622float2(
      __floats2bfloat162_rn(silu_flush(v0), silu_flush(v1)));
  const uint32_t v = pack2(m.x + r.x, m.y + r.y);
  return in_domain ? v : 0u;
}

__global__ void __launch_bounds__(NTHREADS, 1)
mid_kernel(const bf16* __restrict__ x, int H4, int W4,
           const uint4* __restrict__ wf, const float* __restrict__ bias,
           bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const y = smem;               // input planes, then y
  unsigned char* const t = smem + Y_BYTES;     // t, after the input
  unsigned char* const a = smem + IN_BYTES;    // L3, then m0 (chunks 0-3)
  uint4* const ring = reinterpret_cast<uint4*>(a + A_BYTES);   // B_RING
  const uint32_t s_in = smem_u32(smem), s_t = smem_u32(t), s_a = smem_u32(a);
  const int img = blockIdx.z;
  const int H8 = H4 / 2, W8 = W4 / 2;
  const int r0 = blockIdx.y * TH;   // tile origin on the output grid
  const int c0 = blockIdx.x * TW;
  const int ly0 = r0 - 2, lx0 = c0 - 2;   // 12x20 tile origin

  // 1. Input window rows [2*ly0-1, +IH), cols [2*lx0-1, +IW), zero outside
  //    the front grid (L3's padding), 16-byte cp.async straight into the
  //    parity planes: window position (iy, ix), 8-channel run q, lands in
  //    row ((2*(iy&1) + (ix&1))*PH + iy/2)*PW + ix/2 of chunk plane q/2.
  {
    const int iy0 = 2 * ly0 - 1, ix0 = 2 * lx0 - 1;
    const bf16* src = x + (size_t)img * H4 * W4 * 64;
    for (int e = threadIdx.x; e < IH * IW * 8; e += NTHREADS) {
      const int pos = e >> 3, q = e & 7;
      const int iy = pos / IW, ix = pos - iy * IW;
      const int gy = iy0 + iy, gx = ix0 + ix;
      const bool valid =
          (unsigned)gy < (unsigned)H4 && (unsigned)gx < (unsigned)W4;
      const int prow =
          ((2 * (iy & 1) + (ix & 1)) * PH + (iy >> 1)) * PW + (ix >> 1);
      cp_async16(s_in + swz((q >> 1) * IP + prow, q & 1),
                 valid ? src + ((size_t)gy * W4 + gx) * 64 + q * 8 : src,
                 valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // Position p of the 12 x 20 tile lies on the output grid.
  auto in_domain = [&](int p) {
    const int oy = p / LW, ox = p - oy * LW;
    return (unsigned)(ly0 + oy) < (unsigned)H8 &&
           (unsigned)(lx0 + ox) < (unsigned)W8;
  };

  // 2. L3 3x3/s2 64->128 on the 12x20 tile -> a.  Tap (ky, kx) of position
  //    (oy, ox) reads window (2*oy+ky, 2*ox+kx): plane (ky&1, kx&1), row
  //    oy + ky/2, col ox + kx/2.  k-step 4*tap + chunk.
  conv_mma<NWARPS, LP, 128, 36, 2, 8, B_RING>(
      s_in, wf + F_L3, bias + B_L3,
      [](int p) {
        const int oy = p / LW;
        return oy * PW + (p - oy * LW);
      },
      [](int s) {
        const int tp = s >> 2, ky = tp / 3, kx = tp % 3;
        return (s & 3) * IP + (2 * (ky & 1) + (kx & 1)) * PH * PW +
               (ky >> 1) * PW + (kx >> 1);
      },
      [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(a + pair_off(LP, p, co)) =
            silu2(v0, v1, in_domain(p));
      },
      ring);
  __syncthreads();

  // 3. C3 cv1 | cv2 as one 128->128 1x1 -> y (cv1 in chunks 0-3).
  conv_mma<NWARPS, LP, 128, 8, 4, 4, B_RING>(
      s_a, wf + F_C12, bias + B_C12, [](int p) { return p; },
      [](int s) { return s * LP; },
      [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(y + pair_off(LP, p, co)) =
            silu2(v0, v1, in_domain(p));
      },
      ring);
  __syncthreads();

  // 4. Bottleneck 0: m.cv1 1x1 on y's cv1 half over 12x20 -> t; m.cv2 3x3
  //    over the inner 10x18, m0 = bf16(silu) + cv1 -> a's chunks 0-3.
  conv_mma<NWARPS, LP, 64, 4, 2, 4, B_RING>(
      s_in, wf + F_A1, bias + B_A1, [](int p) { return p; },
      [](int s) { return s * LP; },
      [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(t + pair_off(LP, p, co)) =
            silu2(v0, v1, in_domain(p));
      },
      ring);
  __syncthreads();
  conv_mma<NWARPS, BP, 64, 36, 3, 2, B_RING>(
      s_t, wf + F_A2, bias + B_A2,
      [](int p) {
        const int oy = p / (LW - 2);
        return oy * LW + (p - oy * (LW - 2));
      },
      [](int s) { return tap3x3(s); },
      [&](int p, int co, float v0, float v1) {
        const int q = inner_row(p);
        *reinterpret_cast<uint32_t*>(a + pair_off(LP, q, co)) =
            residual2(v0, v1, y + pair_off(LP, q, co), in_domain(q));
      },
      ring);
  __syncthreads();

  // 5. Bottleneck 1: m.cv1 on m0 over the inner 10x18 -> t; m.cv2 over the
  //    central 8x16, m1 = bf16(silu) + m0 -> y's chunks 0-3, so that y's
  //    centre becomes cv3's input [m1 | cv2].
  conv_mma<NWARPS, BP, 64, 4, 3, 2, B_RING>(
      s_a, wf + F_B1, bias + B_B1, [](int p) { return inner_row(p); },
      [](int s) { return s * LP; },
      [&](int p, int co, float v0, float v1) {
        const int q = inner_row(p);
        *reinterpret_cast<uint32_t*>(t + pair_off(LP, q, co)) =
            silu2(v0, v1, in_domain(q));
      },
      ring);
  __syncthreads();
  conv_mma<NWARPS, OP, 64, 36, 2, 2, B_RING>(
      s_t, wf + F_B2, bias + B_B2,
      [](int p) { return ((p >> 4) + 1) * LW + (p & 15) + 1; },
      [](int s) { return tap3x3(s); },
      [&](int p, int co, float v0, float v1) {
        const int q = central_row(p);
        *reinterpret_cast<uint32_t*>(y + pair_off(LP, q, co)) =
            residual2(v0, v1, a + pair_off(LP, q, co), true);
      },
      ring);
  __syncthreads();

  // 6. cv3 1x1 128->128 on [m1 | cv2] over the central 8x16 -> the output,
  //    masked to the output grid (a ragged last tile row or column).
  bf16* const o = out + ((size_t)img * H8 + r0) * W8 * 128 + (size_t)c0 * 128;
  const int rows = H8 - r0, cols = W8 - c0;
  conv_mma<NWARPS, OP, 128, 8, 2, 4, B_RING>(
      s_in, wf + F_C3, bias + B_C3, [](int p) { return central_row(p); },
      [](int s) { return s * LP; },
      [&](int p, int co, float v0, float v1) {
        const int oy = p >> 4, ox = p & 15;
        if (oy < rows && ox < cols)
          *reinterpret_cast<uint32_t*>(
              o + ((size_t)oy * W8 + ox) * 128 + co) =
              pack2(silu_flush(v0), silu_flush(v1));
      },
      ring);
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() after the launch
// (0 on success).  Pointers are device pointers: x (B, H4, W4, 64) bf16;
// wmma the seven layers' bf16 B fragments and bias their 640 fp32 biases,
// as lpr_tpu_torch.kernels.yolo_mid.mid_pack packs them ("mma", "bias");
// out (B, H4/2, W4/2, 128) bf16.
extern "C" int lpr_yolo_mid_bf16(const void* x, const void* wmma,
                                 const void* bias, void* out, int batch,
                                 int h4, int w4, void* stream) {
  if (batch <= 0 || batch > 65535 || h4 <= 0 || w4 <= 0 || h4 % 2 != 0 ||
      w4 % 2 != 0 || reinterpret_cast<uintptr_t>(wmma) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bias) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int h8 = h4 / 2, w8 = w4 / 2;
  const dim3 grid((w8 + TW - 1) / TW, (h8 + TH - 1) / TH, batch);
  mid_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, h4, w4, (const uint4*)wmma, (const float*)bias,
      (bf16*)out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block, for reports.
extern "C" int lpr_yolo_mid_smem_bytes(void) { return SMEM_BYTES; }
// Elements of the packed B fragments (bf16) and biases (fp32) it reads.
extern "C" int lpr_yolo_mid_mma_elems(void) { return F_END * 8; }
extern "C" int lpr_yolo_mid_bias_elems(void) { return B_END; }
