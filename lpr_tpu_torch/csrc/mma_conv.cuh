// Tensor-core building blocks for the port's convolution kernels (sm_90a):
// bf16 tiles staged in shared memory with cp.async, read with ldmatrix and
// multiplied with mma.sync m16n8k16 (bf16 in, float32 accumulators); and
// for float32 operands the TF32 split and mma.sync m16n8k8 (3xTF32).
//
// Tile layout.  A staged tile holds 16 channels of each position as one
// 32-byte row (two 16-byte halves: channels 0-7 and 8-15).  Half h of row
// q lies at byte q*32 + ((h ^ (q >> 2)) & 1) * 16: the 16-byte XOR swizzle
// that makes an ldmatrix of any 8 consecutive rows hit all 32 banks once
// (unswizzled, rows 32 bytes apart put two of them on each bank group).
// The same layout serves the A operand (rows = positions, k = channels)
// and the B operand (rows = output channels n, k = input channels).
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane l holds A rows l/4 and
// l/4 + 8, B column l/4, and accumulator rows l/4, l/4 + 8 at columns
// 2*(l%4), 2*(l%4) + 1.  ldmatrix_x4 with lane l addressing row (l & 15)
// of a 16-row A block, half l >> 4, gives a0..a3 in mma order; with lane l
// addressing row n = 8*(l >> 4) + (l & 7), half (l >> 3) & 1, of a B block
// it gives b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
//
// TF32.  A float32 tile holds 8 channels a 32-byte row (halves: channels
// 0-3 and 4-7), laid out and swizzled as above.  The PTX ISA's fragments
// for mma.m16n8k8 with .tf32: lane l holds a0 = A(l/4, l%4), a1 = A(l/4 +
// 8, l%4), a2 = A(l/4, l%4 + 4), a3 = A(l/4 + 8, l%4 + 4), and b0 = B(k =
// l%4, n = l/4), b1 = B(k = l%4 + 4, n = l/4); the accumulators as above.
// ldmatrix (.b16) gives lane l of each 8x8 matrix word l%4 of row l/4, so
// the same ldmatrix_x4 addressing as bf16 yields these four A registers
// (rows 0-7 / 8-15 x channels 0-3 / 4-7) and b0, b1 of two n-tiles.

#pragma once

#include <stdint.h>

namespace mma_conv {

// Byte offset of 16-byte half h of 32-byte row q in a swizzled tile.
__device__ __forceinline__ int swz(int q, int h) {
  return q * 32 + (((h ^ (q >> 2)) & 1) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst (both 16-byte aligned), through
// L2 only; with valid == false the destination is zero-filled and src is
// not read (it must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b on one 16x8x16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (to nearest, ties away from zero: the rounding of
// cvt.rna.tf32.f32), as float32 bits with the 13 low bits zero: half a
// TF32 ulp added to the magnitude bits, then the 13 low bits cleared (K2
// ~4 % faster so than with the cvt on an NVIDIA H100 80GB HBM3 at 700 W).
// For finite x.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 operands: each float32 a = big + small (+ under 2^-22 |a|),
// big = tf32(a), small = tf32(a - big).  An MMA reads only a TF32's top
// 19 bits, so raw float32 bits would be truncated, not rounded.
__device__ __forceinline__ void tf32_split(const uint32_t (&a)[4],
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = __uint_as_float(a[k]);
    big[k] = tf32_rna(x);
    small[k] = tf32_rna(x - __uint_as_float(big[k]));
  }
}

// c += a * b on one 16x8x8 tile, TF32 in, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_conv
