// Tensor-core building blocks for the port's convolution kernels (sm_90a):
// bf16 tiles staged in shared memory with cp.async, read with ldmatrix and
// multiplied with mma.sync m16n8k16 (bf16 in, float32 accumulators).
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

}  // namespace mma_conv
