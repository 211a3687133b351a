// I1 and I2: the int8 convolution of the quantized plate detector
// (PipelineConfig.int8_detector), the counterpart of lpr_tpu/ops/nn.py:129
// conv2d_int8.  That function is lax.conv on int8 operands with an int32
// result, not a Pallas kernel; PyTorch has no int8 convolution on CUDA and
// its one int8 product, torch._int_mm, is a plain GEMM that would need an
// im2col of every activation.  So both halves are written here by hand.
//
// I1, the per-tensor quantize, is two kernels on the caller's stream.  The
// max pass (lpr_act_amax_*) takes the whole tensor's max|x| (the batch
// included, as the JAX function takes it) into a float32 slot: a
// grid-stride max whose blocks meet in one atomicMax on the float's bits
// (exact: a max does not depend on order, and non-negative floats order
// as their bits do).  It runs only where the model does not already know
// the max: the detector's plan (models/yolo.py plan_amax) carries each
// tensor's max from the I2 epilogues that wrote it, so on the yolov5s path
// it runs once a step, on K1's output.  The quantize (lpr_quantize_act_*)
// reads 1-4 slots (a concat's parts), sx = max(max / 127, 1e-12), and
// writes xq = clamp(rint(x / sx), -127, 127) as int8, NHWC, the channels
// padded with zeros to Cp, a multiple of 32, and sx for I2's epilogue; it
// runs once per tensor (a C3's cv1 and cv2 share it).  No value goes to
// the host, so the frozen step captures all of it.  Bound: bytes (read x
// once, write xq once, at 3.35 TB/s); 16-byte loads where the layout
// allows.
//
// I2 (lpr_conv_int8): the convolution as an implicit GEMM, M = output
// positions, N = Cout, K = taps x Cp, on Hopper's warpgroup MMA,
// wgmma.mma_async m64nNk32 s8 x s8 -> s32.  A block of 288 threads
// computes a tile of up to 128 output positions, th rows of tw positions
// of one image (kernels/conv_int8.py tile_shape), by BN channels (128, or
// 64 where 128 would leave SMs without a block or Cout is 64): warps 0-7
// are two consumer warpgroups of 64 rows each, warp 8 the producer.  A
// stage of the ring holds one tap and 32 ka channels (ka = 4, 2 or 1 as Cp
// allows) of A (128 rows) and of B (BN rows), each row 32 ka bytes in the
// swizzle of that width (the 16-byte chunk index XOR the row's index in
// its group of 8), the layout a K-major wgmma descriptor of type B128,
// B64 or B32 reads, one k-step of 32 bytes at a time.  Both operands come
// by TMA, whose boxes write that swizzle: B as 64-row boxes of int8_pack's
// K-major matrix (its descriptor encoded once per weight), A as one box
// of the quantized input seen as a (Cp, W, H, B) tensor: th x tw
// positions, every stride-th from the tile's corner at the tap, zeros
// where the box leaves the image (the conv's padding) -- the im2col of
// the tile at one tap, with no address arithmetic in the kernel (its
// descriptor encoded at each launch, in the launcher, and passed as a
// __grid_constant__ CUtensorMap).  One producer lane waits a slot's empty
// barrier, posts the stage's bytes on its full barrier and issues the
// boxes; a consumer warpgroup waits the full barrier, issues ka wgmmas on
// its 64 rows, commits, and when the previous stage's group is done
// releases that slot.  A ring of 2-4 stages (up to 96 KB, two blocks an
// SM) takes the place of __syncthreads.
//
// The epilogue runs on the accumulators: the JAX function's float(acc) *
// (sx * w_s[c]), then + b[c], each rounded on its own (__fmul_rn,
// __fadd_rn: no contraction into an FMA); the rounding to the output type;
// the layer's activation as ops/nn.py composes it in PyTorch on the card
// (SiLU: s = T(1 / (1 + expf(-v))), y = T(v * s), |y| < T(1e-30) -> 0;
// leaky: v >= 0 ? v : T(v * 0.1f)); the Bottleneck's residual, T(res + y);
// and, where the next quantize reads it, the max|y| of what it stores, a
// block max and one atomicMax into the tensor's slot.  So each step is bit
// for bit the plain version's, and no SiLU or add kernel follows.  The
// acc instance writes the int32 sums themselves; rows past the tile or
// the image are not stored.
//
// Bound: int8 operations at 1,979 TOPS or bytes at 3.35 TB/s, whichever is
// larger (bytes at most of the detector's shapes).  What the design does
// about it: the weight and the input come by TMA in boxes whose rows are a
// whole stage (32-128 bytes; the mma.sync kernel before it read B per
// warp from global memory and gathered A 16 bytes a copy), a stage carries
// up to 128 channels of a tap, the ring's barriers replace two
// __syncthreads a k-step, a 128-wide N tile reads A once for 128 output
// channels, and the activation, residual and the next layer's max ride in
// the epilogue instead of four to six passes over the output.  What this
// design's predecessors showed on an H100 (clock64 stamps in a block,
// variants timed side by side): issuing the copies was the bound while A
// came by 16-byte cp.async (one or two producer warps alike, lines
// coalesced or not) and while the boxes were 32 bytes wide; a stage's row
// in one box made every 3x3 shape faster; the MMAs and the producer's
// waits are not the bound, the epilogue then takes about a third of the
// time (bf16 stores of 4 bytes a thread, the SiLU).  ptxas reports the
// wgmmas serialized (C7515: the zero-initialised accumulators); starting
// a tile with scale-d 0 clears the report but not the time.  Later work:
// TMA stores of the tile, wider tiles, the quantize folded into the A
// staging.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "mma_conv.cuh"

namespace {

using namespace mma_conv;

constexpr int kThreads = 256;       // I1's blocks
constexpr int BM = 128;             // I2's output positions a block
constexpr int kConsumerWarps = 8;   // two warpgroups of 64 rows
constexpr int kConvThreads = 32 * (kConsumerWarps + 1);
constexpr int K_STEP = 32;          // bytes (int8 channels) of one wgmma
constexpr int TMA_ROWS = 64;        // weight rows a TMA box
constexpr int kRingBytes = 96 * 1024;
constexpr int kMaxSmem = kRingBytes + 1024 + 8 * 2 * 4;
// ops/nn.py silu's flush, |y| < 1e-30, as PyTorch compares it on the card:
// against the scalar in the tensor's type (bf16(1e-30f) = 0x0da2).
constexpr uint32_t kFlushBf16Bits = 0x0da20000u;

enum { ACT_NONE = 0, ACT_SILU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------- I1
template <class T>
__global__ void __launch_bounds__(kThreads)
    amax_kernel(const T* __restrict__ x, long long n,
                unsigned int* __restrict__ amax_bits) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long nv = aligned ? n / V : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  float m = 0.0f;
  for (long long i = tid; i < nv; i += nthreads) {
    union {
      uint4 u;
      T t[V];
    } v;
    v.u = __ldg(xv + i);
#pragma unroll
    for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(to_f(v.t[e])));
  }
  for (long long i = nv * V + tid; i < n; i += nthreads)
    m = fmaxf(m, fabsf(to_f(x[i])));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float wmax[kThreads / 32];
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? wmax[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(amax_bits, __float_as_uint(m));
  }
}

__device__ __forceinline__ int8_t quant(float v, float sx) {
  const int q = __float2int_rn(__fdiv_rn(v, sx));   // half to even
  return static_cast<int8_t>(max(-127, min(127, q)));
}

// The slots whose max is the tensor's max|x|: 1-4 float32 values.
struct Slots {
  const float* p[4];
  int n;
};

// One thread a group of 8 output channels of one position: xq[p, c0:c0+8]
// from x[p, c0:c0+8] (zeros at c >= C).
template <class T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, Slots slots,
                    int8_t* __restrict__ xq, float* __restrict__ sx_out,
                    long long P, int C, int Cp) {
  float amax = slots.p[0][0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (k < slots.n) amax = fmaxf(amax, slots.p[k][0]);
  const float sx = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *sx_out = sx;
  const int G = Cp >> 3;
  const long long total = P * G;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  // 16-byte loads of 8 channels: C % 8 == 0 and a 16-byte aligned base
  constexpr int VB = 8 * sizeof(T) / 16;   // uint4 per 8 channels
  const bool vec = (C & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += nthreads) {
    const long long p = i / G;
    const int c0 = (int)(i - p * G) << 3;
    union {
      uint2 u;
      int8_t q[8];
    } out;
    const T* src = x + p * C + c0;
    if (vec && c0 + 8 <= C) {
      union {
        uint4 u[VB];
        T t[8];
      } v;
#pragma unroll
      for (int j = 0; j < VB; ++j)
        v.u[j] = __ldg(reinterpret_cast<const uint4*>(src) + j);
#pragma unroll
      for (int e = 0; e < 8; ++e) out.q[e] = quant(to_f(v.t[e]), sx);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out.q[e] = c0 + e < C ? quant(to_f(src[e]), sx) : int8_t(0);
    }
    *reinterpret_cast<uint2*>(xq + p * Cp + c0) = out.u;
  }
}

template <class T>
int act_amax(const void* x, long long n, void* slot, void* stream) {
  if (n <= 0 || slot == nullptr) return cudaErrorInvalidValue;
  const long long nv = (n + 16 / sizeof(T) - 1) / (16 / sizeof(T));
  const int grid = (int)min((nv + kThreads - 1) / kThreads, 132LL * 8);
  amax_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, static_cast<unsigned int*>(slot));
  return cudaGetLastError();
}

template <class T>
int quantize_act(const void* x, long long P, int C, int Cp, void* xq,
                 void* sx, const void* s0, const void* s1, const void* s2,
                 const void* s3, int nslots, void* stream) {
  if (P <= 0 || C <= 0 || Cp % 32 || Cp < C || nslots < 1 || nslots > 4)
    return cudaErrorInvalidValue;
  Slots slots{{static_cast<const float*>(s0), static_cast<const float*>(s1),
               static_cast<const float*>(s2), static_cast<const float*>(s3)},
              nslots};
  for (int k = 0; k < nslots; ++k)
    if (slots.p[k] == nullptr) return cudaErrorInvalidValue;
  const long long groups = P * (Cp / 8);
  const int grid = (int)min((groups + kThreads - 1) / kThreads, 132LL * 16);
  quantize_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), slots, static_cast<int8_t*>(xq),
      static_cast<float*>(sx), P, C, Cp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- I2
// mbarriers, TMA and wgmma (PTX ISA 8.x, sm_90a).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// One box of a 4-D tensor map (channels, x, y, image): zeros where it
// leaves the tensor, so a padding tap needs no test.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c, int x, int y,
                                            int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
         "r"(x), "r"(y), "r"(n)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The wgmma descriptor of a K-major operand whose rows are 32 ka bytes
// (one stage: ka 32-byte k-steps) in the swizzle of that width, the 8-row
// groups 256 ka bytes apart, the tile 1024-byte aligned; addr: the tile's
// shared address plus the k-step's 32 kk bytes, as the hardware swizzles
// the address it computes.  Fields: start address >> 4, LBO 1 (unused for
// a swizzled K-major operand), SBO >> 4, layout type (B32 3, B64 2, B128 1).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, int ka) {
  const uint64_t layout = ka == 4 ? 1 : ka == 2 ? 2 : 3;
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(16 * ka) << 32) | (layout << 62);
}

// d += a * b, a 64 x BN x 32 int8 product of one warpgroup: lane l of warp
// w holds d[4 j + 2 h + e] = D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + e].
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Keeps the compiler from moving reads of the accumulators above the
// wgmma wait that completes them.
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

template <int ACT>
__device__ __forceinline__ float act_of(float v) {
  if (ACT == ACT_SILU) {
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
    const float y = __fmul_rn(v, s);
    return fabsf(y) < 1e-30f ? 0.0f : y;
  }
  if (ACT == ACT_LEAKY) return v >= 0.0f ? v : __fmul_rn(v, 0.1f);
  return v;
}

template <int ACT>
__device__ __forceinline__ __nv_bfloat16 act_of(__nv_bfloat16 y) {
  const float v = __bfloat162float(y);
  if (ACT == ACT_SILU) {
    const float s = __bfloat162float(
        __float2bfloat16_rn(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)))));
    const __nv_bfloat16 p = __float2bfloat16_rn(__fmul_rn(v, s));
    return fabsf(__bfloat162float(p)) < __uint_as_float(kFlushBf16Bits)
               ? __float2bfloat16_rn(0.0f) : p;
  }
  if (ACT == ACT_LEAKY)
    return v >= 0.0f ? y : __float2bfloat16_rn(__fmul_rn(v, 0.1f));
  return y;
}

__device__ __forceinline__ void round_to(float v, float& y) { y = v; }
__device__ __forceinline__ void round_to(float v, __nv_bfloat16& y) {
  y = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float add_res(float r, float y) {
  return __fadd_rn(r, y);
}
__device__ __forceinline__ __nv_bfloat16 add_res(__nv_bfloat16 r,
                                                 __nv_bfloat16 y) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(r),
                                       __bfloat162float(y)));
}

__device__ __forceinline__ void store2(int* out, long long i, int v0, int v1,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<int2*>(out + i) = make_int2(v0, v1);
  } else {
    out[i] = v0;
    if (second) out[i + 1] = v1;
  }
}
__device__ __forceinline__ void store2(float* out, long long i, float v0,
                                       float v1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
  } else {
    out[i] = v0;
    if (second) out[i + 1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, long long i,
                                       __nv_bfloat16 v0, __nv_bfloat16 v1,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __halves2bfloat162(v0, v1);
  } else {
    out[i] = v0;
    if (second) out[i + 1] = v1;
  }
}

struct ConvGeom {
  int H, W, Cp, Ho, Wo, Cout, kh, kw, stride, pad_h, pad_w;
  int ka;       // 32-byte k-steps a stage (1, 2 or 4)
  int stages;   // depth of the ring
  int tw, th;   // a block's output tile: th rows of tw positions
  int tiles_x, tiles_y;   // tiles an image
};

// The block's dynamic shared memory: the ring of stages (A rows, then B
// rows), 1024-byte aligned, then a full and an empty barrier a stage.
__host__ __device__ __forceinline__ int stage_bytes(int bn, int ka) {
  return (BM + bn) * K_STEP * ka;
}

// T: the output type (int: the raw sums).  BN: the N tile.  ACT, RES,
// AMAX: the epilogue's activation, residual and max.
template <class T, int BN, int ACT, bool RES, bool AMAX>
__global__ void __launch_bounds__(kConvThreads, 2)
    conv_int8_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ sx_p,
                     const float* __restrict__ w_s,
                     const float* __restrict__ bias,
                     const T* __restrict__ res, T* __restrict__ out,
                     unsigned int* __restrict__ amax, ConvGeom g) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float wmax[kConsumerWarps];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int rb = K_STEP * g.ka;         // bytes of a row of a stage
  const int a_bytes = BM * rb;
  const int b_bytes = BN * rb;
  const int st_bytes = a_bytes + b_bytes;
  const uint32_t bars = base + g.stages * st_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (g.stages + s); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the block's tile: image nb, output rows ty th.., positions tx tw..
  const int tx = blockIdx.x % g.tiles_x, q = blockIdx.x / g.tiles_x;
  const int ty = q % g.tiles_y, nb = q / g.tiles_y;
  const int n0 = blockIdx.y * BN;
  const int cps = g.Cp / rb;           // stages a tap
  const int KS = g.kh * g.kw * cps;
  const int a_box = g.tw * g.th * rb;   // bytes of the A box
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full(s), 1);           // the producer's post of the bytes
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one lane issues every stage's TMA boxes, A's as the
    // tile's input at the tap (strided as the conv, zeros off the image)
    if (lane == 0) {
      const int x0 = tx * g.tw * g.stride - g.pad_w;
      const int y0 = ty * g.th * g.stride - g.pad_h;
      for (int ks = 0, s = 0, round = 0; ks < KS; ++ks) {
        mbar_wait(empty(s), (round & 1) ^ 1);
        const int tap = ks / cps, c0 = (ks - tap * cps) * rb;
        const int dy = tap / g.kw, dx = tap - dy * g.kw;
        const uint32_t a_st = base + s * st_bytes, b_st = a_st + a_bytes;
        mbar_expect_tx(full(s), a_box + b_bytes);
        tma_load_4d(a_st, &xmap, full(s), c0, x0 + dx, y0 + dy, nb);
#pragma unroll
        for (int h = 0; h < BN / TMA_ROWS; ++h)
          tma_load_2d(b_st + h * TMA_ROWS * rb, &wmap, full(s),
                      tap * g.Cp + c0, n0 + h * TMA_ROWS);
        if (++s == g.stages) {
          s = 0;
          ++round;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
    const int wg = warp >> 2;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int ks = 0, s = 0, round = 0, prev = 0; ks < KS; ++ks) {
      mbar_wait(full(s), round & 1);
      const uint32_t st = base + s * st_bytes;
      wgmma_fence();
      for (int kk = 0; kk < g.ka; ++kk)
        Wgmma<BN>::mma(acc,
                       desc_kmajor(st + wg * 64 * rb + kk * K_STEP, g.ka),
                       desc_kmajor(st + a_bytes + kk * K_STEP, g.ka));
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty(prev));
      }
      prev = s;
      if (++s == g.stages) {
        s = 0;
        ++round;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

    // ---- epilogue, from the accumulators
    constexpr bool kRaw = std::is_same<T, int>::value;
    const float sx = *sx_p;
    // this thread's two tile rows r (r and r + 8) as output positions m, or
    // -1 past the tile or the image
    int mrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
      const int oy = ty * g.th + r / g.tw, ox = tx * g.tw + r % g.tw;
      mrow[h] = r < g.tw * g.th && oy < g.Ho && ox < g.Wo
                    ? (nb * g.Ho + oy) * g.Wo + ox : -1;
    }
    const bool even = (g.Cout & 1) == 0;
    float mx = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = n0 + j * 8 + 2 * (lane & 3);
      if (co >= g.Cout) continue;
      const bool second = co + 1 < g.Cout;
      const bool pair = even && second;
      float s0 = 0.0f, s1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
      if (!kRaw) {
        s0 = __fmul_rn(sx, w_s[co]);
        s1 = second ? __fmul_rn(sx, w_s[co + 1]) : 0.0f;
        if (bias != nullptr) {
          b0 = bias[co];
          b1 = second ? bias[co + 1] : 0.0f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (mrow[h] < 0) continue;
        const long long i = (long long)mrow[h] * g.Cout + co;
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        if constexpr (kRaw) {
          store2(out, i, a0, a1, pair, second);
        } else {
          float v0 = __fmul_rn(__int2float_rn(a0), s0);
          float v1 = __fmul_rn(__int2float_rn(a1), s1);
          if (bias != nullptr) {
            v0 = __fadd_rn(v0, b0);
            v1 = __fadd_rn(v1, b1);
          }
          T y0, y1;
          round_to(v0, y0);
          round_to(v1, y1);
          y0 = act_of<ACT>(y0);
          y1 = act_of<ACT>(y1);
          if constexpr (RES) {
            y0 = add_res(res[i], y0);
            if (second) y1 = add_res(res[i + 1], y1);
          }
          store2(out, i, y0, y1, pair, second);
          if constexpr (AMAX) {
            mx = fmaxf(mx, fabsf(to_f(y0)));
            if (second) mx = fmaxf(mx, fabsf(to_f(y1)));
          }
        }
      }
    }
    if constexpr (AMAX) {
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) wmax[warp] = mx;
      asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kConsumerWarps)
                   : "memory");
      if (tid == 0) {
#pragma unroll
        for (int w = 1; w < kConsumerWarps; ++w) mx = fmaxf(mx, wmax[w]);
        atomicMax(amax, __float_as_uint(mx));
      }
    }
  }
}

struct ConvArgs {
  CUtensorMap map;    // the packed weight's
  CUtensorMap xmap;   // the quantized input's, (Cp, W, H, B) in tile boxes
  const float* sx;
  const float* w_s;
  const float* bias;
  const void* res;
  void* out;
  unsigned int* amax;
  ConvGeom g;
  int batch;
  cudaStream_t stream;
};

template <class T, int BN, int ACT, bool RES, bool AMAX>
int launch(const ConvArgs& a) {
  auto kernel = conv_int8_kernel<T, BN, ACT, RES, AMAX>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int smem = 1024 + a.g.stages * (stage_bytes(BN, a.g.ka) + 16);
  const dim3 grid(a.batch * a.g.tiles_x * a.g.tiles_y,
                  (a.g.Cout + BN - 1) / BN);
  kernel<<<grid, kConvThreads, smem, a.stream>>>(
      a.map, a.xmap, a.sx, a.w_s, a.bias, static_cast<const T*>(a.res),
      static_cast<T*>(a.out), a.amax, a.g);
  return cudaGetLastError();
}

template <class T, int BN, int ACT>
int by_flags(bool res, bool amax, const ConvArgs& a) {
  if (res)
    return amax ? launch<T, BN, ACT, true, true>(a)
                : launch<T, BN, ACT, true, false>(a);
  return amax ? launch<T, BN, ACT, false, true>(a)
              : launch<T, BN, ACT, false, false>(a);
}

template <class T, int BN>
int by_act(int act, bool res, bool amax, const ConvArgs& a) {
  switch (act) {
    case ACT_NONE: return by_flags<T, BN, ACT_NONE>(res, amax, a);
    case ACT_SILU: return by_flags<T, BN, ACT_SILU>(res, amax, a);
    case ACT_LEAKY: return by_flags<T, BN, ACT_LEAKY>(res, amax, a);
  }
  return cudaErrorInvalidValue;
}

template <int BN>
int by_type(int out_type, int act, bool res, bool amax, const ConvArgs& a) {
  switch (out_type) {
    case 0:   // the raw int32 sums: no epilogue
      if (act != ACT_NONE || res || amax) return cudaErrorInvalidValue;
      return launch<int, BN, ACT_NONE, false, false>(a);
    case 1: return by_act<__nv_bfloat16, BN>(act, res, amax, a);
    case 2: return by_act<float, BN>(act, res, amax, a);
  }
  return cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library links no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// An int8 tensor of `rank` dims (innermost first; strides in bytes of
// dims 1..) as TMA reads it into I2's stages: boxes of `box` elements
// taken every `elem` elements, box[0] (32, 64 or 128) bytes innermost in
// the swizzle of that width, zeros outside the tensor.  0, 1000 + the
// driver's CUresult, or -1.
int encode(CUtensorMap* map, int rank, const void* ptr, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box,
           const cuuint32_t* elem) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const CUtensorMapSwizzle swizzle =
      box[0] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

}  // namespace

extern "C" {

int lpr_act_amax_bf16(const void* x, long long n, void* slot, void* stream) {
  return act_amax<__nv_bfloat16>(x, n, slot, stream);
}

int lpr_act_amax_f32(const void* x, long long n, void* slot, void* stream) {
  return act_amax<float>(x, n, slot, stream);
}

int lpr_quantize_act_bf16(const void* x, long long P, int C, int Cp,
                          void* xq, void* sx, const void* s0, const void* s1,
                          const void* s2, const void* s3, int nslots,
                          void* stream) {
  return quantize_act<__nv_bfloat16>(x, P, C, Cp, xq, sx, s0, s1, s2, s3,
                                     nslots, stream);
}

int lpr_quantize_act_f32(const void* x, long long P, int C, int Cp, void* xq,
                         void* sx, const void* s0, const void* s1,
                         const void* s2, const void* s3, int nslots,
                         void* stream) {
  return quantize_act<float>(x, P, C, Cp, xq, sx, s0, s1, s2, s3, nslots,
                             stream);
}

// The TMA descriptor of a packed weight w (int8_pack: Np rows of K bytes),
// boxes of 64 rows x 32 ka bytes (one stage's k-steps) in the swizzle of
// that width, written to out (sizeof(CUtensorMap) = 128 bytes).  0, or
// 1000 + the driver's CUresult, or -1 without the driver's entry point.
int lpr_conv_int8_tmap(const void* w, long long K, int Np, int ka, void* out) {
  if ((ka != 1 && ka != 2 && ka != 4) || K <= 0 || K % (K_STEP * ka) ||
      Np <= 0 || Np % TMA_ROWS)
    return 1;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)Np};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)(K_STEP * ka), TMA_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const int err = encode(&map, 2, w, dims, strides, box, elem);
  if (err == 0) memcpy(out, &map, sizeof(map));
  return err;
}

// I2.  out_type: 0 the int32 sums, 1 bf16, 2 float32; bn: 64 or 128; act:
// 0 none, 1 SiLU, 2 leaky; ka: 32-byte k-steps a stage; tw x th: a block's
// output tile (tw th <= 128; tw, th stride <= 256); res, amax, bias:
// nullable.
int lpr_conv_int8(const void* tmap, const void* xq, const void* sx,
                  const void* w_s, const void* bias, const void* res,
                  void* out, void* amax, int out_type, int bn, int act,
                  int ka, int tw, int th, int B, int H, int W, int Cp, int Ho,
                  int Wo, int Cout, int kh, int kw, int stride, int pad_h,
                  int pad_w, void* stream) {
  if (Cp % K_STEP || (ka != 1 && ka != 2 && ka != 4) || Cp % (K_STEP * ka) ||
      B <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0 || (bn != 64 && bn != 128) ||
      tw <= 0 || th <= 0 || tw * th > BM || tw * stride > 256 ||
      th * stride > 256 || stride < 1 || stride > 8)
    return cudaErrorInvalidValue;
  ConvArgs a;
  memcpy(&a.map, tmap, sizeof(a.map));
  // the input as (Cp, W, H, B); a box holds th x tw positions of one image,
  // every stride-th, a stage's 32 ka channels each: the A of a tile at a
  // tap and channel offset, its rows in raster order
  const cuuint64_t dims[4] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Cp, (cuuint64_t)W * Cp,
                                 (cuuint64_t)H * W * Cp};
  const cuuint32_t box[4] = {(cuuint32_t)(K_STEP * ka),
                             (cuuint32_t)(tw * stride),
                             (cuuint32_t)(th * stride), 1};
  const cuuint32_t elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const int err = encode(&a.xmap, 4, xq, dims, strides, box, elem);
  if (err != 0) return err;
  a.sx = static_cast<const float*>(sx);
  a.w_s = static_cast<const float*>(w_s);
  a.bias = static_cast<const float*>(bias);
  a.res = res;
  a.out = out;
  a.amax = static_cast<unsigned int*>(amax);
  a.batch = B;
  const int st = stage_bytes(bn, ka);
  a.g = ConvGeom{H,  W,  Cp,     Ho,     Wo,
                 Cout, kh, kw, stride, pad_h, pad_w, ka,
                 std::max(2, std::min(4, kRingBytes / st)), tw, th,
                 (Wo + tw - 1) / tw, (Ho + th - 1) / th};
  a.stream = static_cast<cudaStream_t>(stream);
  const bool has_res = res != nullptr, has_amax = amax != nullptr;
  return bn == 128 ? by_type<128>(out_type, act, has_res, has_amax, a)
                   : by_type<64>(out_type, act, has_res, has_amax, a);
}

// Every kernel library reports its dynamic shared memory a block (I2's
// largest).
int lpr_conv_int8_smem_bytes() { return kMaxSmem; }

}  // extern "C"
