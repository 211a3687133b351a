// K2 — the whole LPSR forward as one kernel, written by hand for Hopper
// (sm_90a), bound to Python through the plain C launchers at the bottom
// (lpr_tpu_torch/kernels/lpsr.py loads them with ctypes).
//
// Replaces the TPU kernel lpr_tpu/ops/pallas/lpsr_kernel.py:235
// `lpsr_pallas` (body `_forward_block`, :131-196): the AutoEncoder
// (conv_in 3x3; four depthwise-5x5 + pointwise blocks with pixel unshuffle /
// shuffle and ReLU; the conv_in skip; conv_out 3x3), the RDN (shallowF1 7x7,
// shallowF2 3x3, RDB0 -> CSAR -> RDB1 -> CSAR with one shared CSAR, gff0 1x1,
// gff1 3x3 + sfe1) and final_conv 3x3 with a float32 sigmoid.  Input
// (N, H, W, 3) in the activation type T (bf16 or float), output (N, H, W, 1)
// float32.  Every sum is float32; each conv adds its bias in float32 and
// stores T; residual adds, ReLU and the attention products work on stored
// values; the CA mean, its two dense layers and the sigmoids are float32 —
// the rounding points of `_forward_block`.  The TPU kernel's k-major
// (un)shuffle channel order is TPU layout: this kernel indexes PyTorch's
// order, unshuffled channel c*4 + i*2 + j.
//
// What bounds it: one 32x192 image needs 917 M multiply-adds against 37 KB
// of input and 25 KB of output, so it is bound by operations: 44.5 us for
// N = 24 at the 989 TFLOP/s bf16 tensor-core rate.
//
// Design.  A block cannot hold one image's activations (the RDB concat
// alone is 1.2 MB in bf16), and the receptive field and the CSAR channel
// mean span the whole image, so row tiles with halo recompute do not work.
// One launch computes all N images; each image is one thread-block cluster
// of 8 blocks, and each block owns 1/8 of the rows of every layer's grid
// (4 rows at 32x192, 2 at 16x96, 1 at 8x48).  Activations live in a
// per-image scratch in device memory (mostly L2-resident); each layer is a
// stage that writes its own rows, and a cluster barrier (release/acquire at
// cluster scope, after a device fence) separates stages, so the next stage
// reads its neighbours' halo rows.  Scratch is read with ld.global.cg (L2,
// never a stale L1 line).  A convolution stage stages its input rows, halo
// and zero padding included, in shared memory as float32 channel planes, in
// channel chunks where they do not fit (96 KB a block, two blocks an SM);
// the loads are 16-byte vectors, two in flight per thread, since a stage's
// time went to waiting on one L2 load at a time.  Each thread accumulates 4
// positions x G output channels, weights read as warp-uniform float4
// through the read-only cache, and stores 8 channels as one vector.  The
// CSAR channel mean is reduced by every block of the cluster over the whole
// image in one fixed order, so all blocks use the same value and a run is
// deterministic.  Arithmetic is scalar float32 FMA on the CUDA cores;
// tensor cores, TMA and weight staging are later work.
// The weights come as one packed float32 buffer plus an offset table
// (lpr_tpu_torch.kernels.lpsr.PACK_KEYS, mirrored by the enum below).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CLUSTER = 8;     // blocks per image
constexpr int NTHREADS = 256;
constexpr int PX = 4;          // positions per thread work item
constexpr int SMEM_FLOATS = 24576;                 // 96 KB: two blocks an SM
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
constexpr int AUX_FLOATS = 2560;                   // CA reduction and vector
constexpr int CONV_FLOATS = SMEM_FLOATS - AUX_FLOATS;

enum WKey {
  W_AE_CONV_IN_W,
  W_ENC0_DW_W, W_ENC0_DW_B, W_ENC0_PW_W, W_ENC0_PW_B,
  W_ENC1_DW_W, W_ENC1_DW_B, W_ENC1_PW_W, W_ENC1_PW_B,
  W_DEC0_DW_W, W_DEC0_DW_B, W_DEC0_PW_W, W_DEC0_PW_B,
  W_DEC1_DW_W, W_DEC1_DW_B, W_DEC1_PW_W, W_DEC1_PW_B,
  W_AE_CONV_OUT_W,
  W_SF1_W, W_SF1_B, W_SF2_W, W_SF2_B,
  W_RDB0,                                  // l0.w l0.b .. l3.w l3.b lff.w lff.b
  W_RDB1 = W_RDB0 + 10,
  W_CSAR = W_RDB1 + 10,                    // in0 in1 fc1 fc2 sa1 sa2 out (w, b)
  W_GFF0_W = W_CSAR + 14, W_GFF0_B, W_GFF1_W, W_GFF1_B,
  W_FINAL_W, W_FINAL_B,
  W_COUNT
};
static_assert(W_COUNT == 62, "PACK_KEYS has 62 entries");

struct Offsets {
  int o[W_COUNT];
};

// Per-image scratch layout, in elements of T (each buffer NHWC, 8-aligned).
struct Layout {
  long long ci, tmp, u1, u2, s1, a, xb, sfe1, cat, feats, t32, xin, sa1, sa,
      total;
};

__host__ __device__ inline Layout layout(int H, int W) {
  const long long P = (long long)H * W;
  Layout L;
  long long o = 0;
  long long* fields[] = {&L.ci, &L.tmp, &L.u1, &L.u2, &L.s1, &L.a, &L.xb,
                         &L.sfe1, &L.cat, &L.feats, &L.t32, &L.xin, &L.sa1,
                         &L.sa};
  // ci, tmp (every depthwise output), u1 (P/4 x 48), u2 (P/16 x 48),
  // s1 (P/4 x 12), a, xb (3), sfe1, cat (96), feats (128), t32, xin, sa1
  // (64), sa — in channels per full-resolution position.
  const int chans[] = {12, 12, 12, 3, 3, 12, 3, 32, 96, 128, 32, 32, 64, 32};
  for (int i = 0; i < 14; ++i) {
    *fields[i] = o;
    o += (P * chans[i] + 7) & ~7LL;
  }
  L.total = o;
  return L;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back.
template <class T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// Scratch and input loads through L2 only (ld.global.cg).
__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldf(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// 16-byte vectors: 8 bf16 or 4 float values (VEC<T>), loaded through L2.
template <class T> constexpr int VEC = 16 / sizeof(T);
__device__ __forceinline__ void unpack(const uint4& q, float* v, const bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& q, float* v,
                                       const float*) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ uint4 pack(const float* v, const bf16*) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return q;
}
__device__ __forceinline__ uint4 pack(const float* v, const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
// VEC<T> values at p (16-byte aligned) as floats.
template <class T>
__device__ __forceinline__ void ldvec(const T* p, float* v) {
  unpack(__ldcg(reinterpret_cast<const uint4*>(p)), v, p);
}
// 8 values at p (16-byte aligned) as floats, and stored back rounded to T.
template <class T>
__device__ __forceinline__ void ld8(const T* p, float* v) {
#pragma unroll
  for (int k = 0; k < 8; k += VEC<T>) ldvec(p + k, v + k);
}
template <class T>
__device__ __forceinline__ void st8(T* p, const float* v) {
#pragma unroll
  for (int k = 0; k < 8; k += VEC<T>)
    *reinterpret_cast<uint4*>(p + k) = pack(v + k, p);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Release this block's scratch writes and wait for the whole cluster.
__device__ __forceinline__ void stage_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}

// Rows [r0, r1) of an hr-row grid owned by cluster rank `rank`.
__device__ __forceinline__ void own_rows(int hr, int rank, int& r0,
                                         int& r1) {
  r0 = rank * hr / CLUSTER;
  r1 = (rank + 1) * hr / CLUSTER;
}

// Where a convolution stage reads input channel c at (y, x) of its grid:
// LD_PLAIN — channel coff + c of an NHWC buffer with cs channels per
// position; LD_CSAR — CSAR conv_out's input [x_in * T(x_in * ca),
// x_in * sa] built from x_in (buf, 32 channels), sa (32) and ca (32 floats
// in shared memory).
enum LoadMode { LD_PLAIN, LD_CSAR };

template <class T>
struct Src {
  int mode;
  const T* buf;
  int cs, coff;
  const T* sa;
  const float* ca;
};

template <class T>
__host__ __device__ Src<T> plain_src(const T* buf, int cs, int coff) {
  return Src<T>{LD_PLAIN, buf, cs, coff, nullptr, nullptr};
}

// What a stage does with output channel co's float32 sum v (bias included)
// at (y, x) of its grid (width wr):
//   EP_STORE / EP_RELU      buf[pos, coff + co] = T(v) (ReLU'd)
//   EP_UNSHUFFLE_RELU       relu(T(v)) to channel co*4 + (y%2)*2 + x%2 at
//                           (y/2, x/2) of a cs-channel grid of width wr/2
//   EP_SHUFFLE_RELU         relu(T(v)) to channel co/4 at (2y + i, 2x + j),
//                           i = (co/2)%2, j = co%2, of a cs-channel grid of
//                           width 2*wr
//   EP_SHUFFLE_RELU_ADD     the same, plus res at the same index, rounded
//   EP_RESID                T(res[pos, res_coff + co] + T(v)) to buf (and to
//                           channel co of buf2, cs2 channels, when given)
//   EP_SIGMOID              T(sigmoid(T(v)))
//   EP_FINAL                float32 sigmoid(T(v)) to outf[pos]
enum EpiMode {
  EP_STORE, EP_RELU, EP_UNSHUFFLE_RELU, EP_SHUFFLE_RELU, EP_SHUFFLE_RELU_ADD,
  EP_RESID, EP_SIGMOID, EP_FINAL
};

template <class T>
struct Dst {
  int mode;
  T* buf;
  int cs, coff;
  const T* res;
  int res_cs, res_coff;
  T* buf2;
  int cs2;
  float* outf;
};

template <class T>
__host__ __device__ Dst<T> dst(int mode, T* buf, int cs, int coff) {
  return Dst<T>{mode, buf, cs, coff, nullptr, 0, 0, nullptr, 0, nullptr};
}

template <class T>
__device__ __forceinline__ float load_src(const Src<T>& s, int wr, int y,
                                          int x, int c) {
  const size_t pos = (size_t)y * wr + x;
  if (s.mode == LD_PLAIN) return ldf(s.buf + pos * s.cs + s.coff + c);
  const float xi = ldf(s.buf + pos * 32 + (c & 31));
  if (c < 32) return rnd<T>(xi * rnd<T>(xi * s.ca[c]));
  return rnd<T>(xi * ldf(s.sa + pos * 32 + c - 32));
}

// VEC<T> consecutive input channels c .. c+VEC-1 (c a multiple of VEC).
template <class T>
__device__ __forceinline__ void load_src_vec(const Src<T>& s, int wr, int y,
                                             int x, int c, float* v) {
  const size_t pos = (size_t)y * wr + x;
  if (s.mode == LD_PLAIN) {
    ldvec(s.buf + pos * s.cs + s.coff + c, v);
    return;
  }
  constexpr int N = VEC<T>;
  float xi[N];
  ldvec(s.buf + pos * 32 + (c & 31), xi);
  if (c < 32) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = rnd<T>(xi[k] * rnd<T>(xi[k] * s.ca[c + k]));
  } else {
    ldvec(s.sa + pos * 32 + c - 32, v);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = rnd<T>(xi[k] * v[k]);
  }
}

template <class T>
__device__ __forceinline__ void store_dst(const Dst<T>& d, int wr, int y,
                                          int x, int co, float v) {
  const size_t pos = (size_t)y * wr + x;
  switch (d.mode) {
    case EP_STORE:
      d.buf[pos * d.cs + d.coff + co] = from_f<T>(v);
      break;
    case EP_RELU:
      d.buf[pos * d.cs + d.coff + co] = from_f<T>(fmaxf(v, 0.0f));
      break;
    case EP_UNSHUFFLE_RELU:
      d.buf[((size_t)(y >> 1) * (wr >> 1) + (x >> 1)) * d.cs + co * 4 +
            (y & 1) * 2 + (x & 1)] = from_f<T>(fmaxf(v, 0.0f));
      break;
    case EP_SHUFFLE_RELU:
    case EP_SHUFFLE_RELU_ADD: {
      const size_t q = ((size_t)(2 * y + ((co >> 1) & 1)) * (2 * wr) +
                        2 * x + (co & 1)) * d.cs + (co >> 2);
      float r = fmaxf(v, 0.0f);
      if (d.mode == EP_SHUFFLE_RELU_ADD) r = ldf(d.res + q) + rnd<T>(r);
      d.buf[q] = from_f<T>(r);
      break;
    }
    case EP_RESID: {
      const T r = from_f<T>(ldf(d.res + pos * d.res_cs + d.res_coff + co) +
                            rnd<T>(v));
      d.buf[pos * d.cs + d.coff + co] = r;
      if (d.buf2 != nullptr) d.buf2[pos * d.cs2 + co] = r;
      break;
    }
    case EP_SIGMOID:
      d.buf[pos * d.cs + d.coff + co] = from_f<T>(sigmoidf(rnd<T>(v)));
      break;
    case EP_FINAL:
      d.outf[pos] = sigmoidf(rnd<T>(v));
      break;
  }
}

// One KxK / stride-1 / 'same' convolution over the block's own rows of an
// (hr, wr) grid: cin -> cout channels, weights HWIO float32, bias optional,
// input from `src` (zero padding outside the grid), output through `dst`.
template <int K, int G, class T>
__device__ __noinline__ void conv_stage(float* sm, int rank, int hr, int wr,
                                        int cin, int cout,
                                        const float* __restrict__ w,
                                        const float* __restrict__ bias,
                                        Src<T> src, Dst<T> dst) {
  constexpr int P = K / 2;
  constexpr int UK = K <= 3 ? K : 1;   // keep the 7x7's code small
  int r0, r1;
  own_rows(hr, rank, r0, r1);
  const int nrows = r1 - r0;
  if (nrows <= 0) return;
  const int tr = nrows + 2 * P, tc = wr + 2 * P, plane = tr * tc;
  constexpr int NV = VEC<T>;
  // 16-byte loads where every chunk is whole vectors of aligned channels
  const bool vec = cin % NV == 0 &&
                   (src.mode == LD_CSAR || (src.cs % NV == 0 && src.coff % NV == 0));
  int ck = min(cin, CONV_FLOATS / plane);
  if (vec) ck = ck / NV * NV;
  const bool single = ck >= cin;
  const int npos = nrows * wr;
  const int npg = (npos + PX - 1) / PX;
  const int items = npg * (cout / G);

  // Channel planes [c0, c0+cn) of the tile, zero outside the grid.  Each
  // thread issues U independent loads before it stores any, and
  // neighbouring threads take neighbouring positions (conflict-free stores).
  constexpr int U = 2;
  auto load_chunk = [&](int c0, int cn) {
    if (vec) {
      const int total = (cn / NV) * plane;
      for (int e0 = threadIdx.x; e0 < total; e0 += U * NTHREADS) {
        float v[U][NV];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NTHREADS;
          const int pos = e % plane, cv = e / plane;
          const int ty = pos / tc, tx = pos - ty * tc;
          const int gy = r0 - P + ty, gx = tx - P;
          if (e < total && gy >= 0 && gy < hr && gx >= 0 && gx < wr) {
            load_src_vec(src, wr, gy, gx, c0 + cv * NV, v[u]);
          } else {
#pragma unroll
            for (int k = 0; k < NV; ++k) v[u][k] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NTHREADS;
          if (e < total) {
            const int pos = e % plane, cv = e / plane;
#pragma unroll
            for (int k = 0; k < NV; ++k) sm[(cv * NV + k) * plane + pos] = v[u][k];
          }
        }
      }
    } else {
      const int total = cn * plane;
      for (int e0 = threadIdx.x; e0 < total; e0 += U * NTHREADS) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NTHREADS;
          const int pos = e % plane, c = e / plane;
          const int ty = pos / tc, tx = pos - ty * tc;
          const int gy = r0 - P + ty, gx = tx - P;
          v[u] = (e < total && gy >= 0 && gy < hr && gx >= 0 && gx < wr)
                     ? load_src(src, wr, gy, gx, c0 + c) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NTHREADS;
          if (e < total) sm[e] = v[u];     // e == c * plane + pos
        }
      }
    }
  };
  if (single) {
    load_chunk(0, cin);
    __syncthreads();
  }
  for (int base = 0; base < items; base += NTHREADS) {
    const int item = base + threadIdx.x;
    const bool active = item < items;
    const int g = active ? item / npg : 0;
    const int pg = active ? item - g * npg : 0;
    int off[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int pos = min(pg + j * npg, npos - 1);
      const int oy = pos / wr;
      off[j] = oy * tc + (pos - oy * wr);
    }
    float acc[PX][G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float b = (bias != nullptr && active) ? __ldg(bias + g * G + i)
                                                  : 0.0f;
#pragma unroll
      for (int j = 0; j < PX; ++j) acc[j][i] = b;
    }
    for (int c0 = 0; c0 < cin; c0 += ck) {
      const int cn = min(ck, cin - c0);
      if (!single) {
        __syncthreads();
        load_chunk(c0, cn);
        __syncthreads();
      }
      if (!active) continue;
#pragma unroll UK
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll UK
        for (int kx = 0; kx < K; ++kx) {
          const float* wp = w + ((ky * K + kx) * cin + c0) * cout + g * G;
          const float* sp = sm + ky * tc + kx;
          for (int c = 0; c < cn; ++c) {
            float wv[G];
            if constexpr (G % 4 == 0) {
#pragma unroll
              for (int i = 0; i < G; i += 4) {
                const float4 q =
                    __ldg(reinterpret_cast<const float4*>(wp + c * cout + i));
                wv[i] = q.x; wv[i + 1] = q.y; wv[i + 2] = q.z; wv[i + 3] = q.w;
              }
            } else {
#pragma unroll
              for (int i = 0; i < G; ++i) wv[i] = __ldg(wp + c * cout + i);
            }
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              const float v = sp[c * plane + off[j]];
#pragma unroll
              for (int i = 0; i < G; ++i) acc[j][i] = fmaf(v, wv[i], acc[j][i]);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int pos = pg + j * npg;
        if (pos >= npos) continue;
        const int oy = pos / wr, ox = pos - oy * wr;
        const int co = g * G;
        if constexpr (G == 8) {
          // 16-byte loads and stores of 8 channels where the layout is
          // plain NHWC at the position.
          const int m = dst.mode;
          if (m == EP_STORE || m == EP_RELU || m == EP_RESID ||
              m == EP_SIGMOID) {
            const size_t q = (size_t)(r0 + oy) * wr + ox;
            float v[8];
            if (m == EP_RESID) ld8(dst.res + q * dst.res_cs + dst.res_coff + co, v);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float a = acc[j][i];
              v[i] = m == EP_STORE ? a
                   : m == EP_RELU ? fmaxf(a, 0.0f)
                   : m == EP_RESID ? v[i] + rnd<T>(a)
                   : sigmoidf(rnd<T>(a));
            }
            st8(dst.buf + q * dst.cs + dst.coff + co, v);
            if (m == EP_RESID && dst.buf2 != nullptr)
              st8(dst.buf2 + q * dst.cs2 + co, v);
            continue;
          }
        }
#pragma unroll
        for (int i = 0; i < G; ++i)
          store_dst(dst, wr, r0 + oy, ox, co + i, acc[j][i]);
      }
    }
  }
}

// Depthwise 5x5 / 'same' over the block's own rows of an (hr, wr, c) NHWC
// buffer: out = T(sum + bias).
template <class T>
__device__ __noinline__ void dw5_stage(int rank, int hr, int wr, int c,
                                       const T* __restrict__ in,
                                       const float* __restrict__ w,
                                       const float* __restrict__ bias,
                                       T* out) {
  int r0, r1;
  own_rows(hr, rank, r0, r1);
  const int n = (r1 - r0) * wr * c;
  for (int e = threadIdx.x; e < n; e += NTHREADS) {
    const int ch = e % c;
    const int pos = e / c;
    const int y = r0 + pos / wr, x = pos % wr;
    float acc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 5; ++ky) {
      const int iy = y + ky - 2;
      if (iy < 0 || iy >= hr) continue;
#pragma unroll
      for (int kx = 0; kx < 5; ++kx) {
        const int ix = x + kx - 2;
        if (ix < 0 || ix >= wr) continue;
        acc = fmaf(ldf(in + ((size_t)iy * wr + ix) * c + ch),
                   __ldg(w + (ky * 5 + kx) * c + ch), acc);
      }
    }
    out[((size_t)y * wr + x) * c + ch] = from_f<T>(acc + __ldg(bias + ch));
  }
}

template <class T>
struct Img {
  const float* wb;
  Offsets off;
  float* sm;
  int rank, H, W;
  __device__ const float* wt(int k) const { return wb + off.o[k]; }
};

// RDB: four dense 3x3 convs (32, 48, 64, 80 -> 16, ReLU) appended to the
// concat buffer `cat` (96 channels; its channels 0-31 hold the input z),
// then lff 1x1 96 -> 32 (alpha folded) and the residual z -> out.
template <class T>
__device__ void rdb(const Img<T>& im, int wbase, T* cat, T* out, int out_cs,
                    int out_coff) {
  const int H = im.H, W = im.W;
  for (int i = 0; i < 4; ++i) {
    const int cin = 32 + 16 * i;
    conv_stage<3, 8, T>(im.sm, im.rank, H, W, cin, 16, im.wt(wbase + 2 * i),
                        im.wt(wbase + 2 * i + 1), plain_src<T>(cat, 96, 0),
                        dst<T>(EP_RELU, cat, 96, cin));
    stage_barrier();
  }
  Dst<T> d = dst<T>(EP_RESID, out, out_cs, out_coff);
  d.res = cat;
  d.res_cs = 96;
  conv_stage<1, 8, T>(im.sm, im.rank, H, W, 96, 32, im.wt(wbase + 8),
                      im.wt(wbase + 9), plain_src<T>(cat, 96, 0), d);
  stage_barrier();
}

// CSAR on z (channels [z_coff, +32) of a z_cs-channel buffer) -> out (and
// out2 when given), with scratch t32, xin, sa1, sa (32, 32, 64, 32 ch).
template <class T>
__device__ void csar(const Img<T>& im, const T* z, int z_cs, int z_coff,
                     T* out, int out_cs, int out_coff, T* out2, int out2_cs,
                     T* t32, T* xin, T* sa1, T* sa) {
  const int H = im.H, W = im.W;
  const int wb = W_CSAR;
  conv_stage<3, 8, T>(im.sm, im.rank, H, W, 32, 32, im.wt(wb), im.wt(wb + 1),
                      plain_src<T>(z, z_cs, z_coff),
                      dst<T>(EP_RELU, t32, 32, 0));
  stage_barrier();
  conv_stage<3, 8, T>(im.sm, im.rank, H, W, 32, 32, im.wt(wb + 2),
                      im.wt(wb + 3), plain_src<T>(t32, 32, 0),
                      dst<T>(EP_STORE, xin, 32, 0));
  stage_barrier();
  conv_stage<1, 8, T>(im.sm, im.rank, H, W, 32, 64, im.wt(wb + 8),
                      im.wt(wb + 9), plain_src<T>(xin, 32, 0),
                      dst<T>(EP_RELU, sa1, 64, 0));
  stage_barrier();
  conv_stage<1, 8, T>(im.sm, im.rank, H, W, 64, 32, im.wt(wb + 10),
                      im.wt(wb + 11), plain_src<T>(sa1, 64, 0),
                      dst<T>(EP_SIGMOID, sa, 32, 0));
  stage_barrier();

  // Channel attention: the float32 mean of xin over the whole image, by
  // every block in the same order; fc1 32 -> 8, ReLU, fc2 8 -> 32, sigmoid.
  float* red = im.sm + CONV_FLOATS;        // 256 x VEC partial sums
  float* vec = red + 2048;                 // mean (32), hidden (8)
  float* ca = vec + 64;                    // 32
  {
    // Thread t sums VEC channels (group t % NG) over positions t / NG,
    // t / NG + NL, ...; then each channel adds its NL partial sums in order.
    constexpr int NV = VEC<T>, NG = 32 / NV, NL = NTHREADS / NG;
    const int t = threadIdx.x, grp = t % NG, lane = t / NG;
    const int P = H * W;
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.0f;
    for (int p0 = lane; p0 < P; p0 += 4 * NL) {
      float v[4][NV];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pos = p0 + u * NL;
        if (pos < P) {
          ldvec(xin + (size_t)pos * 32 + grp * NV, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < NV; ++k) v[u][k] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < NV; ++k) acc[k] += v[u][k];
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) red[t * NV + k] = acc[k];
    __syncthreads();
    if (t < 32) {
      float m = 0.0f;
      for (int l = 0; l < NL; ++l) m += red[(l * NG + t / NV) * NV + t % NV];
      vec[t] = m / (float)P;
    }
    __syncthreads();
    if (t < 8) {
      const float* w1 = im.wt(wb + 4);
      float h = __ldg(im.wt(wb + 5) + t);
      for (int i = 0; i < 32; ++i) h = fmaf(vec[i], __ldg(w1 + i * 8 + t), h);
      vec[32 + t] = fmaxf(h, 0.0f);
    }
    __syncthreads();
    if (t < 32) {
      const float* w2 = im.wt(wb + 6);
      float v = __ldg(im.wt(wb + 7) + t);
      for (int i = 0; i < 8; ++i)
        v = fmaf(vec[32 + i], __ldg(w2 + i * 32 + t), v);
      ca[t] = sigmoidf(v);
    }
    __syncthreads();
  }
  // conv_out 1x1 64 -> 32 over [x_in * T(x_in * ca), x_in * sa], + z.
  Src<T> s{LD_CSAR, xin, 32, 0, sa, ca};
  Dst<T> d = dst<T>(EP_RESID, out, out_cs, out_coff);
  d.res = z;
  d.res_cs = z_cs;
  d.res_coff = z_coff;
  d.buf2 = out2;
  d.cs2 = out2_cs;
  conv_stage<1, 8, T>(im.sm, im.rank, H, W, 64, 32, im.wt(wb + 12),
                      im.wt(wb + 13), s, d);
  stage_barrier();
}

template <class T>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(NTHREADS, 2)
    lpsr_kernel(const T* __restrict__ x, const float* __restrict__ wb,
                Offsets off, T* __restrict__ scratch, float* __restrict__ out,
                int H, int W) {
  extern __shared__ __align__(16) float sm[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int img = blockIdx.x / CLUSTER;
  const Layout L = layout(H, W);
  T* s = scratch + (size_t)img * L.total;
  T *ci = s + L.ci, *tmp = s + L.tmp, *u1 = s + L.u1, *u2 = s + L.u2,
    *s1 = s + L.s1, *a = s + L.a, *xb = s + L.xb, *sfe1 = s + L.sfe1,
    *cat = s + L.cat, *feats = s + L.feats, *t32 = s + L.t32,
    *xin = s + L.xin, *sa1 = s + L.sa1, *sa = s + L.sa;
  const T* xi = x + (size_t)img * H * W * 3;
  const Img<T> im{wb, off, sm, rank, H, W};
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;

  // ---- AutoEncoder ----------------------------------------------------
  conv_stage<3, 4, T>(sm, rank, H, W, 3, 12, im.wt(W_AE_CONV_IN_W), nullptr,
                      plain_src<T>(xi, 3, 0), dst<T>(EP_STORE, ci, 12, 0));
  stage_barrier();
  dw5_stage<T>(rank, H, W, 12, ci, im.wt(W_ENC0_DW_W), im.wt(W_ENC0_DW_B),
               tmp);
  stage_barrier();
  // enc0 pw 12 -> 12, unshuffle to (H/2, W/2, 48), ReLU.
  conv_stage<1, 4, T>(sm, rank, H, W, 12, 12, im.wt(W_ENC0_PW_W),
                      im.wt(W_ENC0_PW_B), plain_src<T>(tmp, 12, 0),
                      dst<T>(EP_UNSHUFFLE_RELU, u1, 48, 0));
  stage_barrier();
  dw5_stage<T>(rank, H2, W2, 48, u1, im.wt(W_ENC1_DW_W), im.wt(W_ENC1_DW_B),
               tmp);
  stage_barrier();
  // enc1 pw 48 -> 12, unshuffle to (H/4, W/4, 48), ReLU.
  conv_stage<1, 4, T>(sm, rank, H2, W2, 48, 12, im.wt(W_ENC1_PW_W),
                      im.wt(W_ENC1_PW_B), plain_src<T>(tmp, 48, 0),
                      dst<T>(EP_UNSHUFFLE_RELU, u2, 48, 0));
  stage_barrier();
  dw5_stage<T>(rank, H4, W4, 48, u2, im.wt(W_DEC0_DW_W), im.wt(W_DEC0_DW_B),
               tmp);
  stage_barrier();
  // dec0 pw 48 -> 48, shuffle to (H/2, W/2, 12), ReLU.
  conv_stage<1, 8, T>(sm, rank, H4, W4, 48, 48, im.wt(W_DEC0_PW_W),
                      im.wt(W_DEC0_PW_B), plain_src<T>(tmp, 48, 0),
                      dst<T>(EP_SHUFFLE_RELU, s1, 12, 0));
  stage_barrier();
  dw5_stage<T>(rank, H2, W2, 12, s1, im.wt(W_DEC1_DW_W), im.wt(W_DEC1_DW_B),
               tmp);
  stage_barrier();
  // dec1 pw 12 -> 48, shuffle to (H, W, 12), ReLU, + conv_in.
  {
    Dst<T> d = dst<T>(EP_SHUFFLE_RELU_ADD, a, 12, 0);
    d.res = ci;
    conv_stage<1, 8, T>(sm, rank, H2, W2, 12, 48, im.wt(W_DEC1_PW_W),
                        im.wt(W_DEC1_PW_B), plain_src<T>(tmp, 12, 0), d);
  }
  stage_barrier();
  conv_stage<3, 3, T>(sm, rank, H, W, 12, 3, im.wt(W_AE_CONV_OUT_W), nullptr,
                      plain_src<T>(a, 12, 0), dst<T>(EP_STORE, xb, 3, 0));
  stage_barrier();

  // ---- RDN ------------------------------------------------------------
  conv_stage<7, 8, T>(sm, rank, H, W, 3, 32, im.wt(W_SF1_W), im.wt(W_SF1_B),
                      plain_src<T>(xb, 3, 0), dst<T>(EP_STORE, sfe1, 32, 0));
  stage_barrier();
  conv_stage<3, 8, T>(sm, rank, H, W, 32, 32, im.wt(W_SF2_W), im.wt(W_SF2_B),
                      plain_src<T>(sfe1, 32, 0), dst<T>(EP_STORE, cat, 96, 0));
  stage_barrier();
  rdb<T>(im, W_RDB0, cat, feats, 128, 0);
  // CSAR's output is the next RDB's input: also stored into cat[0:32].
  csar<T>(im, feats, 128, 0, feats, 128, 32, cat, 96, t32, xin, sa1, sa);
  rdb<T>(im, W_RDB1, cat, feats, 128, 64);
  csar<T>(im, feats, 128, 64, feats, 128, 96, nullptr, 0, t32, xin, sa1, sa);
  conv_stage<1, 8, T>(sm, rank, H, W, 128, 32, im.wt(W_GFF0_W),
                      im.wt(W_GFF0_B), plain_src<T>(feats, 128, 0),
                      dst<T>(EP_STORE, t32, 32, 0));
  stage_barrier();
  // gff1 3x3 + sfe1 -> xin (free by now).
  {
    Dst<T> d = dst<T>(EP_RESID, xin, 32, 0);
    d.res = sfe1;
    d.res_cs = 32;
    conv_stage<3, 8, T>(sm, rank, H, W, 32, 32, im.wt(W_GFF1_W),
                        im.wt(W_GFF1_B), plain_src<T>(t32, 32, 0), d);
  }
  stage_barrier();
  {
    Dst<T> d = dst<T>(EP_FINAL, (T*)nullptr, 1, 0);
    d.outf = out + (size_t)img * H * W;
    conv_stage<3, 1, T>(sm, rank, H, W, 32, 1, im.wt(W_FINAL_W),
                        im.wt(W_FINAL_B), plain_src<T>(xin, 32, 0), d);
  }
}

template <class T>
int launch(const void* x, const void* wbuf, const int* offsets,
           int n_offsets, void* scratch, void* out, int n, int h, int w,
           void* stream) {
  if (n_offsets != W_COUNT || n <= 0 || h <= 0 || w <= 0 || h % 4 != 0 ||
      w % 4 != 0 || (long long)n * CLUSTER > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // The widest staged plane (shallowF1's 7x7: own rows + 6 by w + 6) must
  // leave room for at least one channel.
  if ((long long)((h + CLUSTER - 1) / CLUSTER + 6) * (w + 6) > CONV_FLOATS)
    return (int)cudaErrorInvalidValue;
  Offsets off;
  for (int i = 0; i < W_COUNT; ++i) {
    if (offsets[i] < 0 || offsets[i] % 4 != 0)
      return (int)cudaErrorInvalidValue;
    off.o[i] = offsets[i];
  }
  cudaError_t err = cudaFuncSetAttribute(
      lpsr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  lpsr_kernel<T><<<n * CLUSTER, NTHREADS, SMEM_BYTES,
                   (cudaStream_t)stream>>>(
      (const T*)x, (const float*)wbuf, off, (T*)scratch, (float*)out, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K2 on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  x (n, h, w, 3) in the activation type; wbuf the packed float32
// weights and `offsets` (host memory) their 62 offsets in PACK_KEYS order;
// scratch n * lpr_lpsr_scratch_elems(h, w) elements of the activation type;
// out (n, h, w, 1) float32.
extern "C" int lpr_lpsr_bf16(const void* x, const void* wbuf,
                             const int* offsets, int n_offsets, void* scratch,
                             void* out, int n, int h, int w, void* stream) {
  return launch<bf16>(x, wbuf, offsets, n_offsets, scratch, out, n, h, w,
                      stream);
}

extern "C" int lpr_lpsr_f32(const void* x, const void* wbuf,
                            const int* offsets, int n_offsets, void* scratch,
                            void* out, int n, int h, int w, void* stream) {
  return launch<float>(x, wbuf, offsets, n_offsets, scratch, out, n, h, w,
                       stream);
}

// Scratch elements per image, or -1 for a shape the kernel does not take.
extern "C" long long lpr_lpsr_scratch_elems(int h, int w) {
  if (h <= 0 || w <= 0 || h % 4 != 0 || w % 4 != 0) return -1;
  return layout(h, w).total;
}

// Dynamic shared memory per block, for reports.
extern "C" int lpr_lpsr_smem_bytes(void) { return SMEM_BYTES; }
