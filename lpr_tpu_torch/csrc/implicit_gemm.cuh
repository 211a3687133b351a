// One convolution as an implicit GEMM on the tensor cores, and its
// epilogue helpers: the routine that K1 (yolo_front.cu) and K3
// (yolo_mid.cu) run every one of their convolutions through.  Built on
// mma_conv.cuh's tile layout, ldmatrix and mma.sync m16n8k16 (bf16 in,
// float32 accumulators).
//
// A layer's input is a tile in shared memory in mma_conv.cuh's layout: 16
// channels of a position in one swizzled 32-byte row, one plane of rows
// per 16-channel chunk.  A convolution is then M = output positions, N =
// output channels, K = taps x 16-channel chunks: lane-row r of an m-tile
// reads its A row at k-step s from row(p) + koff(s), so a tap is a shift
// of row indices and needs no gather.  B comes as fragments in fragment
// order (lpr_tpu_torch.kernels.yolo_front.b_frags): per k-step, per pair
// of n-tiles, per lane, 16 bytes that hold the lane's b0/b1 words of both
// n-tiles.  Two routes bring them to the MMAs (conv_mma's RING):
//   RING == 0  each warp reads its fragments with one __ldg a pair, from
//              L1/L2, which every block shares;
//   RING >= 2  the block copies each k-step's slice of fragments (all n
//              tiles) with cp.async into a ring of RING slices in shared
//              memory, RING - 1 k-steps ahead, and its warps read them
//              there in lockstep, one barrier a k-step: a block reads the
//              weights from L2 once a layer.  K3 measured it 20-24 %
//              slower than __ldg (yolo_mid.cu B_RING), so only the
//              variant tool builds it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_conv.cuh"

namespace implicit_gemm {

using namespace mma_conv;

// SiLU with the flush, through the SFU's approximate exp2 and reciprocal
// (ex2.approx.ftz, rcp.approx.ftz; subnormals flush, as the flush below
// does anyway): a few float32 ulps from the IEEE quotient, so the bf16
// rounding of a result flips now and then, as a sum taken in another order
// does.  IEEE expf and division make K1 1.51x slower (0.550 against 0.365
// ms at (8, 736, 1280, 3); tools/front_variants.py) for
// 1.4 % fewer outputs that differ from front_plain by an ulp (69,434
// against 70,386 of 7.5 M at (2, 736, 1280, 3), the largest error the
// same).  For v < -88, 1 + exp(-v) is inf and its reciprocal 0.
__device__ __forceinline__ float silu_flush(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  const float y = v * r;
  return fabsf(y) < 1e-30f ? 0.0f : y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// SiLU of a channel pair (or zeros outside the domain) as two bf16,
// computed either way and selected, so that no branch splits the warp.
__device__ __forceinline__ uint32_t silu2(float a, float b, bool in_domain) {
  const uint32_t v = pack2(silu_flush(a), silu_flush(b));
  return in_domain ? v : 0u;
}

// Byte offset of channels (co, co+1) of row pos in a tile of np rows a
// chunk plane.
__device__ __forceinline__ int pair_off(int np, int pos, int co) {
  return swz((co >> 4) * np + pos, (co >> 3) & 1) + (co & 7) * 2;
}

// One convolution as an implicit GEMM: NPOS output positions x N output
// channels, K = KS k-steps of 16 input channels.  Lane-row r of m-tile t
// is position p = min(16t + r, NPOS - 1); its A row at k-step s is row
// row(p) + koff(s) of the tile at shared address `in` (koff folds the tap's
// shift and the input chunk's plane).  A warp's unit of work is MT m-tiles
// x NTW n-tiles, units dealt round-robin to the block's NWARPS warps (with
// RING, exactly one a warp, and `ring` holds RING slices of N * 32 bytes).
// The epilogue gets each position's fp32 sums, bias included, a channel
// pair at a time: epi(p, co, v[co], v[co + 1]).  A padding row is clamped
// there too, so it writes row NPOS - 1's values again, which keeps the
// epilogue free of branches; an epilogue that reads what it writes needs
// NPOS % 16 == 0.
template <int NWARPS, int NPOS, int N, int KS, int MT, int NTW, int RING = 0,
          class Row, class Koff, class Epi>
__device__ __forceinline__ void conv_mma(uint32_t in,
                                         const uint4* __restrict__ wf,
                                         const float* __restrict__ bias,
                                         Row row, Koff koff, Epi epi,
                                         uint4* ring = nullptr) {
  constexpr int NT = N / 8;
  constexpr int NMT = (NPOS + 15) / 16;
  constexpr int NMG = (NMT + MT - 1) / MT;
  constexpr int NNG = NT / NTW;
  constexpr int SLICE = NT / 2 * 32;   // uint4 of B fragments a k-step
  constexpr int SLOTS = RING > 0 ? RING : 1;
  static_assert(NT % NTW == 0 && NTW % 2 == 0, "n-tiles in pairs");
  static_assert(RING == 0 || (RING >= 2 && NMG * NNG == NWARPS),
                "the ring's warps move through k in lockstep, one unit each");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // slice s of the weights into the ring's slot s % RING
  auto load_slice = [&](int s) {
    for (int e = threadIdx.x; e < SLICE; e += NWARPS * 32)
      cp_async16(smem_u32(ring + (s % SLOTS) * SLICE + e),
                 wf + s * SLICE + e, true);
  };
  if constexpr (RING > 0) {
#pragma unroll
    for (int s = 0; s < RING - 1; ++s) {
      if (s < KS) load_slice(s);
      cp_async_commit();
    }
  }
  for (int u = warp; u < NMG * NNG; u += NWARPS) {
    const int mg = u / NNG, ng = u - mg * NNG;
    int qa[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      qa[i] = row(min((mg * MT + i) * 16 + (lane & 15), NPOS - 1));
    float acc[MT][NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(
          bias + (ng * NTW + j) * 8 + 2 * (lane & 3)));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][j][0] = b.x;
        acc[i][j][1] = b.y;
        acc[i][j][2] = b.x;
        acc[i][j][3] = b.y;
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if constexpr (RING > 0) {
        // slice s has landed for every thread, and slot (s - 1) % RING,
        // read at k-step s - 1, is free for slice s + RING - 1
        cp_async_wait<RING - 2>();
        __syncthreads();
        if (s + RING - 1 < KS) load_slice(s + RING - 1);
        cp_async_commit();
      }
      uint32_t b[NTW][2];
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        const uint4 v =
            RING > 0
                ? ring[(s % SLOTS) * SLICE + (ng * (NTW / 2) + jp) * 32 + lane]
                : __ldg(wf + (s * (NT / 2) + ng * (NTW / 2) + jp) * 32 + lane);
        b[2 * jp][0] = v.x;
        b[2 * jp][1] = v.y;
        b[2 * jp + 1][0] = v.z;
        b[2 * jp + 1][1] = v.w;
      }
      const int off = koff(s);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, in + swz(qa[i] + off, lane >> 4));
#pragma unroll
        for (int j = 0; j < NTW; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p =
            min((mg * MT + i) * 16 + (lane >> 2) + 8 * h, NPOS - 1);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          epi(p, (ng * NTW + j) * 8 + 2 * (lane & 3), acc[i][j][2 * h],
              acc[i][j][2 * h + 1]);
      }
  }
  if constexpr (RING > 0) cp_async_wait<0>();   // the empty tail groups
}

}  // namespace implicit_gemm
