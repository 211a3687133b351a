// I1 and I2: the int8 convolution of the quantized plate detector
// (PipelineConfig.int8_detector), the counterpart of lpr_tpu/ops/nn.py:129
// conv2d_int8.  That function is lax.conv on int8 operands with an int32
// result, not a Pallas kernel; PyTorch has no int8 convolution on CUDA and
// its one int8 product, torch._int_mm, is a plain GEMM that would need an
// im2col of every activation.  So both halves are written here by hand.
//
// I1 (lpr_quantize_act_*): the whole tensor's max|x| (the batch included,
// as the JAX function takes it), sx = max(amax / 127, 1e-12), then
// xq = clamp(rint(x / sx), -127, 127) as int8, NHWC, with the channels
// padded with zeros to Cp, a multiple of 32 (one k-step of I2).  Two
// kernels and a memset on the caller's stream: a grid-stride max whose
// blocks meet in one atomicMax on the float's bits (exact: a max does not
// depend on order, and non-negative floats order as their bits do), then
// the quantize, which also writes sx for I2's epilogue.  No value goes to
// the host, so the frozen step can capture both as graph nodes.  Bound:
// bytes (read x once, write xq once, at 3.35 TB/s); the loads and stores
// are 16 and 8 bytes a thread where the layout allows.
//
// I2 (lpr_conv_int8_*): the convolution as an implicit GEMM, M = output
// positions (B * Ho * Wo), N = Cout, K = taps x Cp, on
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  A block of 4 warps
// computes a 128 x 64 tile; each warp 64 x 32 (4 x 4 mma tiles).  A k-step
// is one tap and 32 input channels: each thread stages its output row's 32
// bytes with two 16-byte cp.async into a swizzled 32-byte row
// (mma_conv.cuh's tile layout; a padding tap or a row past M is
// zero-filled), double-buffered; the warps read A with ldmatrix (an int8
// m16n8k32 A fragment has the byte layout of a bf16 m16n8k16 one) and B as
// fragments that int8_pack (kernels/conv_int8.py) lays out once at load,
// 16 bytes a lane per n-tile pair, with __ldg.  The epilogue is the JAX
// function's: float(acc) * (sx * w_s[c]), then + b[c], each rounded on
// its own (__fmul_rn, __fadd_rn: no contraction into an FMA), then rounded
// to the output type; the acc instance writes the int32 sums themselves.
// Bound: int8 operations at 1,979 TOPS or bytes at 3.35 TB/s, whichever is
// larger; a simple first kernel (no wgmma, no TMA, no fusion of I1 into
// the previous layer), measured against its bound in chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_conv.cuh"

namespace {

using namespace mma_conv;

constexpr int kThreads = 256;   // I1's blocks
constexpr int BM = 128;         // I2's output positions a block
constexpr int BN = 64;          // I2's output channels a block
constexpr int kConvThreads = 128;

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

// One thread a group of 8 output channels of one position: xq[p, c0:c0+8]
// from x[p, c0:c0+8] (zeros at c >= C).
template <class T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x,
                    const unsigned int* __restrict__ amax_bits,
                    int8_t* __restrict__ xq, float* __restrict__ sx_out,
                    long long P, int C, int Cp) {
  const float amax = __uint_as_float(*amax_bits);
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
int quantize_act(const void* x, long long P, int C, int Cp, void* xq,
                 void* sx, void* amax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || C <= 0 || Cp % 32 || Cp < C) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  const long long n = P * C;
  const long long nv = (n + 16 / sizeof(T) - 1) / (16 / sizeof(T));
  const int g1 = (int)min((nv + kThreads - 1) / kThreads, 132LL * 8);
  amax_kernel<T><<<g1, kThreads, 0, s>>>(static_cast<const T*>(x), n,
                                         static_cast<unsigned int*>(amax));
  const long long groups = P * (Cp / 8);
  const int g2 = (int)min((groups + kThreads - 1) / kThreads, 132LL * 16);
  quantize_kernel<T><<<g2, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const unsigned int*>(amax),
      static_cast<int8_t*>(xq), static_cast<float*>(sx), P, C, Cp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- I2
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvGeom {
  int H, W, Cp, Ho, Wo, Cout, Np, kh, kw, stride, pad_h, pad_w, M;
};

// The dequantized pair (v0, v1) of output channels (co, co + 1) of row m.
__device__ __forceinline__ void store2(__nv_bfloat16* out, long long i,
                                       float v0, float v1, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(v0, v1);
  } else {
    out[i] = __float2bfloat16_rn(v0);
    if (second) out[i + 1] = __float2bfloat16_rn(v1);
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

template <class T>
__device__ __forceinline__ void epilogue(T* out, long long i, int a0, int a1,
                                         float s0, float s1, float b0,
                                         float b1, bool has_bias, bool pair,
                                         bool second) {
  float v0 = __fmul_rn(__int2float_rn(a0), s0);
  float v1 = __fmul_rn(__int2float_rn(a1), s1);
  if (has_bias) {
    v0 = __fadd_rn(v0, b0);
    v1 = __fadd_rn(v1, b1);
  }
  store2(out, i, v0, v1, pair, second);
}

// The acc instance: the int32 sums as they are.
__device__ __forceinline__ void epilogue(int* out, long long i, int a0,
                                         int a1, float, float, float, float,
                                         bool, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<int2*>(out + i) = make_int2(a0, a1);
  } else {
    out[i] = a0;
    if (second) out[i + 1] = a1;
  }
}

template <class T>
__global__ void __launch_bounds__(kConvThreads)
    conv_int8_kernel(const int8_t* __restrict__ xq,
                     const uint4* __restrict__ wf,
                     const float* __restrict__ sx_p,
                     const float* __restrict__ w_s,
                     const float* __restrict__ bias, T* __restrict__ out,
                     ConvGeom g) {
  __shared__ __align__(128) uint8_t As[2][BM * 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nchunk = g.Cp >> 5;
  const int KS = g.kh * g.kw * nchunk;
  // the output row this thread stages
  const int m = m0 + tid;
  const bool row_ok = m < g.M;
  int b = 0, oy = 0, ox = 0;
  if (row_ok) {
    ox = m % g.Wo;
    const int t = m / g.Wo;
    oy = t % g.Ho;
    b = t / g.Ho;
  }
  const int iy0 = oy * g.stride - g.pad_h, ix0 = ox * g.stride - g.pad_w;
  const int8_t* xb = xq + (long long)b * g.H * g.W * g.Cp;
  auto stage = [&](int s, int buf) {
    const int tap = s / nchunk, ch = s - tap * nchunk;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int iy = iy0 + dy, ix = ix0 + dx;
    const bool ok = row_ok && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const int8_t* src =
        ok ? xb + ((long long)iy * g.W + ix) * g.Cp + ch * 32 : xq;
    const uint32_t dst = smem_u32(&As[buf][0]);
    cp_async16(dst + swz(tid, 0), src, ok);
    cp_async16(dst + swz(tid, 1), src + 16, ok);
  };
  const int wm = warp & 1, wn = warp >> 1;   // 64 rows x 32 columns a warp
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  const int pairs = g.Np >> 4;
  const int pair0 = (n0 >> 4) + wn * 2;
  stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < KS; ++s) {
    if (s + 1 < KS) stage(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    uint32_t bf[4][2];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const uint4 v = __ldg(wf + ((long long)s * pairs + pair0 + jp) * 32 + lane);
      bf[2 * jp][0] = v.x;
      bf[2 * jp][1] = v.y;
      bf[2 * jp + 1][0] = v.z;
      bf[2 * jp + 1][1] = v.w;
    }
    const uint32_t base = smem_u32(&As[s & 1][0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, base + swz(wm * 64 + i * 16 + (lane & 15), lane >> 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a, bf[j][0], bf[j][1]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const float sx = *sx_p;
  const bool has_bias = bias != nullptr;
  const bool even = (g.Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + wn * 32 + j * 8 + 2 * (lane & 3);
    if (co >= g.Cout) continue;
    const bool second = co + 1 < g.Cout;
    const float s0 = __fmul_rn(sx, w_s[co]);
    const float s1 = second ? __fmul_rn(sx, w_s[co + 1]) : 0.0f;
    const float b0 = has_bias ? bias[co] : 0.0f;
    const float b1 = has_bias && second ? bias[co + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + (lane >> 2) + 8 * h;
        if (row >= g.M) continue;
        epilogue(out, (long long)row * g.Cout + co, acc[i][j][2 * h],
                 acc[i][j][2 * h + 1], s0, s1, b0, b1, has_bias,
                 even && second, second);
      }
  }
}

template <class T>
int conv_int8(const void* xq, const void* wf, const void* sx, const void* w_s,
              const void* bias, void* out, int B, int H, int W, int Cp,
              int Ho, int Wo, int Cout, int Np, int kh, int kw, int stride,
              int pad_h, int pad_w, void* stream) {
  if (Cp % 32 || Np % BN || Np < Cout || B <= 0 || Ho <= 0 || Wo <= 0)
    return cudaErrorInvalidValue;
  ConvGeom g{H, W, Cp, Ho, Wo, Cout, Np, kh, kw, stride, pad_h, pad_w,
             B * Ho * Wo};
  const dim3 grid((g.M + BM - 1) / BM, Np / BN);
  conv_int8_kernel<T><<<grid, kConvThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint4*>(wf),
      static_cast<const float*>(sx), static_cast<const float*>(w_s),
      static_cast<const float*>(bias), static_cast<T*>(out), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lpr_quantize_act_bf16(const void* x, long long P, int C, int Cp,
                          void* xq, void* sx, void* amax, void* stream) {
  return quantize_act<__nv_bfloat16>(x, P, C, Cp, xq, sx, amax, stream);
}

int lpr_quantize_act_f32(const void* x, long long P, int C, int Cp, void* xq,
                         void* sx, void* amax, void* stream) {
  return quantize_act<float>(x, P, C, Cp, xq, sx, amax, stream);
}

#define LPR_CONV_INT8(NAME, T)                                               \
  int NAME(const void* xq, const void* wf, const void* sx, const void* w_s,  \
           const void* bias, void* out, int B, int H, int W, int Cp, int Ho, \
           int Wo, int Cout, int Np, int kh, int kw, int stride, int pad_h,  \
           int pad_w, void* stream) {                                        \
    return conv_int8<T>(xq, wf, sx, w_s, bias, out, B, H, W, Cp, Ho, Wo,     \
                        Cout, Np, kh, kw, stride, pad_h, pad_w, stream);     \
  }

LPR_CONV_INT8(lpr_conv_int8_bf16, __nv_bfloat16)
LPR_CONV_INT8(lpr_conv_int8_f32, float)
LPR_CONV_INT8(lpr_conv_int8_acc, int)

// Every kernel library reports its dynamic shared memory a block.
int lpr_conv_int8_smem_bytes() { return 0; }

}  // extern "C"
