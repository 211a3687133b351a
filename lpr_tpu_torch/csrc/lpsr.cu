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
// reads its neighbours' halo rows.  Scratch is read through L2 only
// (ld.global.cg, cp.async.cg: never a stale L1 line).  The CSAR channel
// mean: each block sums its own rows, and after a cluster sync every block
// adds the 8 blocks' sums in rank order from their shared memory, so all
// use the same value and a run is deterministic.
//
// Two kinds of convolution stage.  The 23 wide ones (shallowF2, the 8 RDB dense
// layers and 2 lff, the CSAR in0/in1/sa1/sa2/out twice, gff0, gff1: ~95 % of
// the multiply-adds; every channel count a multiple of 16, every epilogue plain
// NHWC) are implicit GEMMs on the tensor cores: M = the block's output
// positions, N = cout, K = taps x cin; one routine (conv_mma) serves both
// instances.  The bf16 instance uses mma.sync m16n8k16 bf16 -> float32
// (mma_conv.cuh).  The input is staged as
// bf16 NHWC tiles of 16 channels ((rows + 2P) x (cols + 2P) positions, 32 bytes
// each, 16-byte XOR swizzle so ldmatrix is conflict free) with cp.async,
// zero-filled outside the grid, double-buffered: step k + 1 lands while step k
// multiplies, a 1x1 stage taking several chunks a step.  Each chunk's weights
// come with it, already bf16 in the B-operand layout (lpsr_pack's second
// buffer), so every chunk is staged once per slab.  The 8 warps split M (m16
// tiles interleaved) and keep their float32 accumulators, started from the
// float32 bias, in registers across all chunks; where a block's rows do not fit
// one tile or its accumulators, the stage walks row (and column) slabs.  The
// lff weights (mat(lff) * alpha, up to 16 significant bits) come as an exact
// bf16 pair hi + lo, two MMAs per step into one accumulator.  The float32
// instance runs the same GEMMs as 3xTF32: float32 tiles of 8 channels
// (32-byte rows: the same tile layout), each A register split in
// registers into TF32 big + small, the weights split by lpsr_pack (its TF32
// tiles), and a_small*b_big + a_big*b_small + a_big*b_big, three mma.sync
// m16n8k8 a k-step, into float32 accumulators: ~22 significant bits a product
// (float32 has 24), where one TF32 product (11) would break the float32
// instance's 1e-4 bound.  Its big + small B tiles are twice bf16's bytes a
// chunk; two of them fit the same shared memory beside two A tiles of A_ROWS_F
// positions, as many as a slab of its 3 m16 tiles a warp (2 rows of 192 and
// halo) needs, so it keeps two blocks an SM and both double buffers.  The CSAR
// conv_out's input, the attention products, is written by each block for its
// own rows into a free buffer first.  The other 12 stages (conv_in, conv_out,
// final, the 7x7 shallowF1 with 3 input channels, the four depthwise 5x5 and
// the four autoencoder pointwise ones with 12/48 channels and (un)shuffle
// epilogues) hold ~5 % of the work and keep the scalar float32 FMA path
// (conv_stage, dw5_stage) in both instances: float32 channel planes in shared
// memory, 4 positions x G channels a thread.
//
// What bounds it now.  Two blocks an SM (all 192 blocks of N = 24 resident
// on 132 SMs) cap a thread at 128 registers, and the shared memory leaves
// an SM ~28 KB of L1, so a spilled register waits on L2.  The wide stages
// are held by those spills, by their per-step latency (a 1x1 stage has
// little arithmetic to hide a step's staging behind) and by the cluster
// barrier each stage ends with, not by the MMA rate; the kernel's pointers,
// offset tables and each wide stage's operands are kept in shared memory
// (KState, MmaStage) and read where needed, which freed registers.  The
// scalar stages cost about what they did before.  An 8-block cluster is
// placed within one GPC, so fewer clusters than 264 / 8 run at once: the
// kernel's time is whole waves of one image's latency.
// The weights come as one packed float32 buffer plus an offset table
// (lpr_tpu_torch.kernels.lpsr.PACK_KEYS, mirrored by the enum W_*) and,
// for the wide stages, a buffer of B tiles in the activation type (bf16,
// or float32 holding TF32 big + small) plus its offset table (MMA_KEYS,
// enum M_*).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_conv.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CLUSTER = 8;     // blocks per image
constexpr int NTHREADS = 256;
constexpr int PX = 4;          // positions per thread work item
// Shared memory: a convolution stage's region, then the CA reduction and
// vector (AUX).  A bf16 tensor-core stage splits its region into two A
// tiles (A_ROWS positions of 16 bf16 channels: 6 x 194 at 32x192 with the
// 3x3 halo) and two B tiles (one chunk's weights: 9 taps x 32 outputs x 16
// channels); the scalar stages use it as float32 planes.  101 KB a block:
// two blocks an SM.
constexpr int A_ROWS = 1168;
constexpr int A_BYTES = A_ROWS * 32;
constexpr int B_BYTES = 9 * 32 * 32;
constexpr int CONV_FLOATS = 2 * (A_BYTES + B_BYTES) / 4;
// The float32 instance's tensor-core stages split the same region into two
// A tiles of A_ROWS_F (880) positions of 8 float32 channels (32 bytes
// each; 4 x 194 at 32x192) and two B tiles (one chunk's weights as TF32
// big + small: 2 x 9 taps x 32 outputs x 8 channels).
constexpr int B_BYTES_F = 2 * 9 * 32 * 32;
constexpr int A_BYTES_F = (CONV_FLOATS * 4 / 2 - B_BYTES_F) & ~127;
constexpr int A_ROWS_F = A_BYTES_F / 32;
constexpr int AUX_FLOATS = 2560;
constexpr int SMEM_FLOATS = CONV_FLOATS + AUX_FLOATS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(SMEM_BYTES <= 113 * 1024, "two blocks an SM");
static_assert(2 * (A_BYTES_F + B_BYTES_F) <= CONV_FLOATS * 4, "A_BYTES_F");

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

// The wide stages' bf16 weights (lpr_tpu_torch.kernels.lpsr.MMA_KEYS).
enum MKey {
  M_SF2,
  M_RDB0,                                  // l0 .. l3, lff
  M_RDB1 = M_RDB0 + 5,
  M_CSAR = M_RDB1 + 5,                     // in0 in1 sa1 sa2 out
  M_GFF0 = M_CSAR + 5, M_GFF1,
  M_COUNT
};
static_assert(M_COUNT == 18, "MMA_KEYS has 18 entries");

struct MOffsets {
  int o[M_COUNT];
};

// Per-image scratch buffers, each NHWC: ci, tmp (every depthwise output),
// u1 (P/4 x 48), u2 (P/16 x 48), s1 (P/4 x 12), a, xb (3), sfe1, cat
// (96), feats (128), t32, xin, sa1 (64), sa.
enum Buf {
  B_CI, B_TMP, B_U1, B_U2, B_S1, B_A, B_XB, B_SFE1, B_CAT, B_FEATS, B_T32,
  B_XIN, B_SA1, B_SA, NBUF
};

// Offsets of the buffers in elements of T (8-aligned), and the total.
struct Layout {
  long long off[NBUF], total;
};

__host__ __device__ inline Layout layout(int H, int W) {
  const long long P = (long long)H * W;
  // channels per full-resolution position
  const int chans[NBUF] = {12, 12, 12, 3, 3, 12, 3, 32, 96, 128, 32, 32, 64,
                           32};
  Layout L;
  long long o = 0;
  for (int i = 0; i < NBUF; ++i) {
    L.off[i] = o;
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
// channel coff + c of an NHWC buffer with cs channels per position.
template <class T>
struct Src {
  const T* buf;
  int cs, coff;
};

template <class T>
__host__ __device__ Src<T> plain_src(const T* buf, int cs, int coff) {
  return Src<T>{buf, cs, coff};
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
  return ldf(s.buf + ((size_t)y * wr + x) * s.cs + s.coff + c);
}

// VEC<T> consecutive input channels c .. c+VEC-1 (c a multiple of VEC).
template <class T>
__device__ __forceinline__ void load_src_vec(const Src<T>& s, int wr, int y,
                                             int x, int c, float* v) {
  ldvec(s.buf + ((size_t)y * wr + x) * s.cs + s.coff + c, v);
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
  const bool vec =
      cin % NV == 0 && src.cs % NV == 0 && src.coff % NV == 0;
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

// A wide stage's operands (their channel offsets applied) and slab
// geometry, kept in shared memory by conv_mma and read (volatile) where it
// stages a step or stores a slab, so that they hold no registers across
// its inner loop: spilled registers miss the L1 that the shared memory
// leaves and wait on L2.
template <class T>
struct MmaStage {
  const T* in;
  const T* wm;
  const float* bias;
  T* out;
  const T* res;
  T* out2;
  int in_cs, out_cs, res_cs, out2_cs;      // channels a position
  int hr, wr, r0, r1, rs, cs, ncx, nchunk, nsub, nps, nstep, sub;
};

// Step k of a wide stage: slab origin (y0, x0), its rows x cols, and its
// chunks [c0, c0 + nc).
struct MmaStep {
  int y0, x0, rows, cols, c0, nc;
};

template <class T>
__device__ __forceinline__ MmaStep mma_step(const volatile MmaStage<T>& d,
                                            int k) {
  const int nps = d.nps, ncx = d.ncx, rs = d.rs, cs = d.cs;
  const int s = k / nps, sy = s / ncx, sx = s - sy * ncx;
  MmaStep t;
  t.c0 = (k - s * nps) * d.nsub;
  t.nc = min(d.nsub, d.nchunk - t.c0);
  t.y0 = d.r0 + sy * rs;
  t.x0 = sx * cs;
  t.rows = min(rs, d.r1 - t.y0);
  t.cols = min(cs, d.wr - t.x0);
  return t;
}

// What differs between the instances' wide stages, besides the MMA:
// channels a staged chunk (one 32-byte row a position), the A and B tile
// sizes, and how two adjacent output channels add their residual and are
// stored.
template <class T> struct Wide;
template <> struct Wide<bf16> {
  static constexpr int CH = 16, AR = A_ROWS, AB = A_BYTES, BB = B_BYTES;
  typedef __nv_bfloat162 T2;
  static __device__ __forceinline__ T2 pair(float v0, float v1) {
    return __floats2bfloat162_rn(v0, v1);
  }
  // v += the two bf16 residuals at p (the lower channel in the low half),
  // v rounded to bf16 first
  static __device__ __forceinline__ void add_res(float& v0, float& v1,
                                                 const bf16* p) {
    const unsigned r = __ldcg(reinterpret_cast<const unsigned*>(p));
    v0 = __uint_as_float(r << 16) + rnd<bf16>(v0);
    v1 = __uint_as_float(r & 0xffff0000u) + rnd<bf16>(v1);
  }
};
template <> struct Wide<float> {
  static constexpr int CH = 8, AR = A_ROWS_F, AB = A_BYTES_F, BB = B_BYTES_F;
  typedef float2 T2;
  static __device__ __forceinline__ T2 pair(float v0, float v1) {
    return make_float2(v0, v1);
  }
  static __device__ __forceinline__ void add_res(float& v0, float& v1,
                                                 const float* p) {
    const float2 r = __ldcg(reinterpret_cast<const float2*>(p));
    v0 += r.x;
    v1 += r.y;
  }
};

// One KxK / stride-1 / 'same' convolution over the block's own rows of an
// (hr, wr) grid on the tensor cores: cin -> NT*8 channels, cin a multiple
// of 16, input channels [coff, coff + cin) of `src` (cs % 8 == 0, coff % 16
// == 0), output through `dst` with epilogue MODE (EP_STORE, EP_RELU,
// EP_RESID or EP_SIGMOID, rounded as store_dst rounds).  `st` is the
// block's MmaStage.
//
// bf16: mma.sync m16n8k16 over chunks of 16 channels.  `wm` holds the
// stage's weights as bf16 B tiles, chunk-major: for each chunk, PARTS x
// K*K taps x NT*8 output rows of 32 bytes, swizzled as mma_conv.cuh says
// (PARTS == 2: an exact pair hi, lo, both multiplied into one
// accumulator).
//
// float32, as 3xTF32: mma.sync m16n8k8 .tf32 over chunks of 8 float32
// channels, one 32-byte row a position, so the tile layout, swizzle and
// ldmatrix addressing are bf16's (mma_conv.cuh gives the fragments).  Each
// A register is split in registers into TF32 big + small (tf32_split);
// `wm` holds the weights already split, chunk-major: for each chunk, big
// then small, each K*K taps x NT*8 output rows of 32 bytes (lpsr_pack's
// TF32 tiles).  Every k-step adds a_small * b_big, a_big * b_small and
// a_big * b_big: each product keeps ~22 of float32's 24 bits, and the
// stores round nothing (the float32 epilogues of store_dst).
//
// The block's rows are cut into slabs of whole rows (and, for a very wide
// grid, columns) whose halo'd tile fits the A tile and whose positions fit
// the warps' accumulators (8 warps x MT m16 tiles, interleaved), which
// start from the float32 bias.  A step stages NSUB consecutive chunks of
// one slab (as many as the A and B tiles hold: several for a 1x1 stage,
// one for a 3x3) into one of two buffers with cp.async, while the step
// before multiplies; the slab's last step ends with the epilogue.
template <int K, int NT, int PARTS, int MODE, class T>
__device__ __forceinline__ void conv_mma(float* smf, MmaStage<T>* st,
                                         int rank, int hr, int wr, int cin,
                                         const T* __restrict__ wm,
                                         const float* __restrict__ bias,
                                         const Src<T>& src,
                                         const Dst<T>& dst) {
  using namespace mma_conv;
  typedef Wide<T> G;
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr int P = K / 2, TAPS = K * K, COUT = NT * 8, CH = G::CH;
  // B tiles a chunk: bf16 the weight, or (PARTS == 2) its exact pair hi,
  // lo; float32 TF32 big, small (the lff too: 3xTF32 covers it).
  constexpr int NPART = BF ? PARTS : 2;
  // m16 tiles per warp under the 128-register cap of two blocks an SM.
  // bf16: 6 for 16 output channels (one slab of 768 positions at 32x192),
  // 2 for 32 or 64 (the measured best of 12 / NT, 8 / NT and these).
  // float32: 3 (two rows of 192 a slab) for 16 or 32, 1 for 64.
  constexpr int MT = BF ? (NT == 2 ? 6 : 2) : (NT == 8 ? 1 : 3);
  constexpr int MAXPOS = (NTHREADS / 32) * MT * 16;
  constexpr int BCHUNK = NPART * TAPS * COUT * 32;     // bytes per chunk
  static_assert(NT % 2 == 0 && MT >= 1, "two n8 tiles per ldmatrix");
  static_assert(BCHUNK <= G::BB, "a chunk's weights fit a B tile");
  int r0, r1;
  own_rows(hr, rank, r0, r1);
  const int nrows = r1 - r0;
  if (nrows <= 0) return;
  const int tid = threadIdx.x;
  if (tid == 0) {
    // Slabs: ncx column pieces of cs columns, nry row pieces of rs rows;
    // nsub chunks a step, in sub-tiles of the largest slab's tile.
    const int cs_max = min(MAXPOS, G::AR / (1 + 2 * P) - 2 * P);
    const int ncx = (wr + cs_max - 1) / cs_max;
    const int cs = (wr + ncx - 1) / ncx;
    int rs = min(nrows, min(MAXPOS / cs, G::AR / (cs + 2 * P) - 2 * P));
    const int nry = (nrows + rs - 1) / rs;
    rs = (nrows + nry - 1) / nry;
    const int nchunk = cin / CH;
    const int sub = ((rs + 2 * P) * (cs + 2 * P) * 32 + 127) & ~127;
    const int nsub = min(nchunk, min(G::AB / sub, G::BB / BCHUNK));
    const int nps = (nchunk + nsub - 1) / nsub;
    *st = MmaStage<T>{src.buf + src.coff, wm, bias, dst.buf + dst.coff,
                      dst.res + dst.res_coff, dst.buf2, src.cs, dst.cs,
                      dst.res_cs, dst.cs2, hr, wr, r0, r1, rs, cs, ncx,
                      nchunk, nsub, nps, nry * ncx * nps, sub};
  }
  __syncthreads();
  const volatile MmaStage<T>& d = *st;
  char* const sm = reinterpret_cast<char*>(smf);
  const uint32_t a_sm = smem_u32(sm), b_sm = smem_u32(sm + 2 * G::AB);

  // Stage step k's chunks and their weights into buffer k & 1.
  auto fetch = [&](int k) {
    const MmaStep t = mma_step(d, k);
    const int tc = t.cols + 2 * P, n = (t.rows + 2 * P) * tc * 2;
    const int h_r = d.hr, w_r = d.wr, in_cs = d.in_cs, sub = d.sub;
    const uint32_t a = a_sm + (k & 1) * G::AB;
    for (int j = 0; j < t.nc; ++j) {
      const T* g0 = d.in + (t.c0 + j) * CH;
      for (int e = tid; e < n; e += NTHREADS) {
        const int q = e >> 1, h = e & 1;
        const int ty = q / tc, tx = q - ty * tc;
        const int gy = t.y0 - P + ty, gx = t.x0 - P + tx;
        const bool in = gy >= 0 && gy < h_r && gx >= 0 && gx < w_r;
        cp_async16(a + j * sub + swz(q, h),
                   in ? g0 + ((size_t)gy * w_r + gx) * in_cs + h * (CH / 2)
                      : g0,
                   in);
      }
    }
    const char* w =
        reinterpret_cast<const char*>(d.wm) + (size_t)t.c0 * BCHUNK;
    const uint32_t b = b_sm + (k & 1) * G::BB;
    for (int e = tid; e < t.nc * BCHUNK / 16; e += NTHREADS)
      cp_async16(b + e * 16, w + e * 16, true);
    cp_async_commit();
  };

  const int warp = tid >> 5, lane = tid & 31;
  float acc[MT][NT][4];
  int qa[MT];            // this lane's A row in the tile, at tap (0, 0)
  fetch(0);
  for (int k = 0; k < d.nstep; ++k) {
    if (k + 1 < d.nstep) {
      fetch(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int nc, tc;
    {
      const MmaStep t = mma_step(d, k);
      nc = t.nc;
      tc = t.cols + 2 * P;
      if (t.c0 == 0) {
        const int np = t.rows * t.cols;
        const float* b = d.bias;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int p = min((warp + 8 * i) * 16 + (lane & 15), np - 1);
          const int oy = p / t.cols;
          qa[i] = oy * tc + p - oy * t.cols;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(
                b + jn * 8 + 2 * (lane & 3)));
            acc[i][jn][0] = b2.x;
            acc[i][jn][1] = b2.y;
            acc[i][jn][2] = b2.x;
            acc[i][jn][3] = b2.y;
          }
        }
      }
    }
    const uint32_t a_buf = a_sm + (k & 1) * G::AB;
    const uint32_t b_buf = b_sm + (k & 1) * G::BB;
    const int sub = d.sub;
#pragma unroll 1
    for (int j = 0; j < nc; ++j) {
#pragma unroll 1
      for (int t = 0; t < TAPS; ++t) {
        const int dq = (t / K) * tc + t % K;
        uint32_t bf[NPART][NT][2];
#pragma unroll
        for (int part = 0; part < NPART; ++part) {
#pragma unroll
          for (int jn = 0; jn < NT; jn += 2) {
            const int row = (part * TAPS + t) * COUT + jn * 8 +
                            8 * (lane >> 4) + (lane & 7);
            uint32_t r[4];
            ldmatrix_x4(r, b_buf + j * BCHUNK + swz(row, (lane >> 3) & 1));
            bf[part][jn][0] = r[0];
            bf[part][jn][1] = r[1];
            bf[part][jn + 1][0] = r[2];
            bf[part][jn + 1][1] = r[3];
          }
        }
        // Every warp multiplies all MT tiles: a tile past the slab's end
        // repeats its last position and is not stored (branching around
        // it here sends the accumulators to local memory).
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t a[4];
          ldmatrix_x4(a, a_buf + j * sub + swz(qa[i] + dq, lane >> 4));
          if constexpr (BF) {
#pragma unroll
            for (int part = 0; part < PARTS; ++part)
#pragma unroll
              for (int jn = 0; jn < NT; ++jn)
                mma_bf16(acc[i][jn], a, bf[part][jn][0], bf[part][jn][1]);
          } else {
            // A k-step's three products go into a zeroed partial sum that
            // a float32 add (round to nearest) then takes into the
            // accumulator: the tensor cores' own accumulation truncates,
            // and with up to 270 MMAs straight into one accumulator (rdb
            // d3) the output drifted about 20x further from lpsr_plain.
            constexpr int PNT = NT < 4 ? NT : 4;   // n8 tiles a partial sum
            uint32_t big[4], small[4];
            tf32_split(a, big, small);
#pragma unroll
            for (int j0 = 0; j0 < NT; j0 += PNT) {
              float part[PNT][4] = {};
#pragma unroll
              for (int jn = 0; jn < PNT; ++jn)
                mma_tf32(part[jn], small, bf[0][j0 + jn][0],
                         bf[0][j0 + jn][1]);
#pragma unroll
              for (int jn = 0; jn < PNT; ++jn)
                mma_tf32(part[jn], big, bf[1][j0 + jn][0], bf[1][j0 + jn][1]);
#pragma unroll
              for (int jn = 0; jn < PNT; ++jn)
                mma_tf32(part[jn], big, bf[0][j0 + jn][0], bf[0][j0 + jn][1]);
#pragma unroll
              for (int jn = 0; jn < PNT; ++jn)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[i][j0 + jn][r] += part[jn][r];
            }
          }
        }
      }
    }
    const MmaStep t = mma_step(d, k);
    if (t.c0 + t.nc == d.nchunk) {
      // Epilogue: lane holds rows lane/4 and lane/4 + 8 of each m16 tile,
      // channels jn*8 + 2*(lane%4) and + 1 of each n8 tile.
      const int np = t.rows * t.cols, wr_ = d.wr;
      T* const out = d.out;
      const T* const res = d.res;
      T* const out2 = d.out2;
      const int out_cs = d.out_cs, res_cs = d.res_cs, out2_cs = d.out2_cs;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const int p = (warp + 8 * i) * 16 + (lane >> 2) + 8 * hrow;
          if (p >= np) continue;
          const int oy = p / t.cols;
          const size_t pos =
              (size_t)(t.y0 + oy) * wr_ + t.x0 + p - oy * t.cols;
          const int c = 2 * (lane & 3);
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            float v0 = acc[i][jn][2 * hrow], v1 = acc[i][jn][2 * hrow + 1];
            if constexpr (MODE == EP_RELU) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            } else if constexpr (MODE == EP_RESID) {
              G::add_res(v0, v1, res + pos * res_cs + jn * 8 + c);
            } else if constexpr (MODE == EP_SIGMOID) {
              v0 = sigmoidf(rnd<T>(v0));
              v1 = sigmoidf(rnd<T>(v1));
            } else {
              static_assert(MODE == EP_STORE, "a plain NHWC epilogue");
            }
            const typename G::T2 v = G::pair(v0, v1);
            *reinterpret_cast<typename G::T2*>(out + pos * out_cs + jn * 8 +
                                               c) = v;
            if (MODE == EP_RESID && out2 != nullptr)
              *reinterpret_cast<typename G::T2*>(out2 + pos * out2_cs +
                                                 jn * 8 + c) = v;
          }
        }
      }
    }
    __syncthreads();
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

// What every stage of one image reads, in shared memory: the weight
// buffers and their offset tables, and the image's scratch buffers.
// Read (volatile) where a stage needs them: pointers derived once and held
// in registers across the kernel crowd out the tensor-core stages'
// accumulators (two blocks an SM leave 128 registers a thread).
template <class T>
struct KState {
  const float* wb;
  const T* wm;
  T* bufs[NBUF];
  int off[W_COUNT];
  int moff[M_COUNT];
};

template <class T>
struct Img {
  const KState<T>* ks;
  MmaStage<T>* stage;            // the wide stages' MmaStage
  float* sm;
  int rank, H, W;
  __device__ const volatile KState<T>& s() const {
    return *const_cast<const volatile KState<T>*>(ks);
  }
  __device__ const float* wt(int k) const { return s().wb + s().off[k]; }
  __device__ const T* mw(int k) const { return s().wm + s().moff[k]; }
  __device__ T* buf(int b) const { return s().bufs[b]; }
};

// One of the 23 wide convolution stages at full resolution, cin -> NT*8
// channels with its bias at W key `wkey` + 1 and B tiles at M key `mkey`
// (bf16, or TF32 big + small in the float32 instance), epilogue MODE
// (== dst.mode): on the tensor cores, in bf16 or as 3xTF32.
template <int K, int NT, int PARTS, int MODE, class T>
__device__ __forceinline__ void wide_conv(const Img<T>& im, int cin, int wkey,
                                          int mkey, Src<T> src, Dst<T> dst) {
  conv_mma<K, NT, PARTS, MODE>(im.sm, im.stage, im.rank, im.H, im.W, cin,
                               im.mw(mkey), im.wt(wkey + 1), src, dst);
}

// RDB: four dense 3x3 convs (32, 48, 64, 80 -> 16, ReLU) appended to the
// concat buffer cat (96 channels; its channels 0-31 hold the input z),
// then lff 1x1 96 -> 32 (alpha folded) and the residual z -> channels
// [out_coff, +32) of feats.
template <class T>
__device__ void rdb(const Img<T>& im, int wbase, int mbase, int out_coff) {
  for (int i = 0; i < 4; ++i) {
    const int cin = 32 + 16 * i;
    wide_conv<3, 2, 1, EP_RELU>(im, cin, wbase + 2 * i, mbase + i,
                                plain_src<T>(im.buf(B_CAT), 96, 0),
                                dst<T>(EP_RELU, im.buf(B_CAT), 96, cin));
    stage_barrier();
  }
  Dst<T> d = dst<T>(EP_RESID, im.buf(B_FEATS), 128, out_coff);
  d.res = im.buf(B_CAT);
  d.res_cs = 96;
  wide_conv<1, 4, 2, EP_RESID>(im, 96, wbase + 8, mbase + 4,
                               plain_src<T>(im.buf(B_CAT), 96, 0), d);
  stage_barrier();
}

// CSAR on z (channels [z_coff, +32) of feats) -> channels [out_coff, +32)
// of feats (and channels 0-31 of cat when to_cat), with scratch t32, xin,
// sa1, sa (32, 32, 64, 32 channels).
template <class T>
__device__ void csar(const Img<T>& im, int z_coff, int out_coff,
                     bool to_cat) {
  const int H = im.H, W = im.W;
  const int wb = W_CSAR, mb = M_CSAR;
  wide_conv<3, 4, 1, EP_RELU>(im, 32, wb, mb,
                              plain_src<T>(im.buf(B_FEATS), 128, z_coff),
                              dst<T>(EP_RELU, im.buf(B_T32), 32, 0));
  stage_barrier();
  wide_conv<3, 4, 1, EP_STORE>(im, 32, wb + 2, mb + 1,
                               plain_src<T>(im.buf(B_T32), 32, 0),
                               dst<T>(EP_STORE, im.buf(B_XIN), 32, 0));
  stage_barrier();
  wide_conv<1, 8, 1, EP_RELU>(im, 32, wb + 8, mb + 2,
                              plain_src<T>(im.buf(B_XIN), 32, 0),
                              dst<T>(EP_RELU, im.buf(B_SA1), 64, 0));
  stage_barrier();
  wide_conv<1, 4, 1, EP_SIGMOID>(im, 64, wb + 10, mb + 3,
                                 plain_src<T>(im.buf(B_SA1), 64, 0),
                                 dst<T>(EP_SIGMOID, im.buf(B_SA), 32, 0));
  stage_barrier();

  // Channel attention: the float32 mean of xin over the whole image; fc1
  // 32 -> 8, ReLU, fc2 8 -> 32, sigmoid.  Each block sums its own rows
  // (part), the cluster syncs, and every block adds the 8 blocks' sums in
  // rank order from their shared memory, so all use the same value and a
  // run is deterministic.
  float* red = im.sm + CONV_FLOATS;        // 256 x VEC partial sums
  float* part = red + 2048;                // this block's sums (32)
  float* vec = part + 32;                  // mean (32), hidden (8)
  float* ca = vec + 64;                    // 32
  {
    // Thread t sums VEC channels (group t % NG) over own positions
    // t / NG, t / NG + NL, ...; then each channel adds its NL partial sums
    // in order.
    constexpr int NV = VEC<T>, NG = 32 / NV, NL = NTHREADS / NG;
    const T* xin = im.buf(B_XIN);
    const int t = threadIdx.x, grp = t % NG, lane = t / NG;
    int r0, r1;
    own_rows(H, im.rank, r0, r1);
    const int p_end = r1 * W;
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.0f;
    for (int p0 = r0 * W + lane; p0 < p_end; p0 += 4 * NL) {
      float v[4][NV];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pos = p0 + u * NL;
        if (pos < p_end) {
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
      part[t] = m;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (t < 32) {
      float m = 0.0f;
      for (int r = 0; r < CLUSTER; ++r)
        m += cluster.map_shared_rank(part, r)[t];
      vec[t] = m / (float)(H * W);
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
  // conv_out's input [x_in * T(x_in * ca), x_in * sa], rounded to T, for
  // the block's own rows into sa1 (64 channels, free since sa2): conv_out
  // is 1x1, so the block reads only what it wrote.
  {
    constexpr int NV = VEC<T>, NG = 64 / NV;
    const T *xin = im.buf(B_XIN), *sa = im.buf(B_SA);
    T* sa1 = im.buf(B_SA1);
    int r0, r1;
    own_rows(H, im.rank, r0, r1);
    const int n = (r1 - r0) * W * NG;
    // U items a thread in flight: their loads before any store.
    constexpr int U = 4;
    for (int e0 = threadIdx.x; e0 < n; e0 += U * NTHREADS) {
      float xi[U][NV], v[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = min(e0 + u * NTHREADS, n - 1);
        const size_t pos = (size_t)r0 * W + e / NG;
        const int c = (e % NG) * NV;
        ldvec(xin + pos * 32 + (c & 31), xi[u]);
        if (c >= 32) ldvec(sa + pos * 32 + c - 32, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NTHREADS;
        if (e >= n) break;
        const size_t pos = (size_t)r0 * W + e / NG;
        const int c = (e % NG) * NV;
        if (c < 32) {
#pragma unroll
          for (int k = 0; k < NV; ++k)
            v[u][k] = rnd<T>(xi[u][k] * rnd<T>(xi[u][k] * ca[c + k]));
        } else {
#pragma unroll
          for (int k = 0; k < NV; ++k) v[u][k] = rnd<T>(xi[u][k] * v[u][k]);
        }
        *reinterpret_cast<uint4*>(sa1 + pos * 64 + c) = pack(v[u], sa1);
      }
    }
    __syncthreads();
  }
  // conv_out 1x1 64 -> 32, + z.
  Dst<T> d = dst<T>(EP_RESID, im.buf(B_FEATS), 128, out_coff);
  d.res = im.buf(B_FEATS);
  d.res_cs = 128;
  d.res_coff = z_coff;
  if (to_cat) {
    d.buf2 = im.buf(B_CAT);
    d.cs2 = 96;
  }
  wide_conv<1, 4, 1, EP_RESID>(im, 64, wb + 12, mb + 4,
                               plain_src<T>(im.buf(B_SA1), 64, 0), d);
  stage_barrier();
}

template <class T>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(NTHREADS, 2)
    lpsr_kernel(const T* __restrict__ x, const float* __restrict__ wb,
                const __grid_constant__ Offsets off,
                const T* __restrict__ wm,
                const __grid_constant__ MOffsets moff,
                T* __restrict__ scratch, float* __restrict__ out, int H,
                int W) {
  extern __shared__ __align__(128) float sm[];
  __shared__ KState<T> ks;
  __shared__ MmaStage<T> stage;
  const int rank = (int)cg::this_cluster().block_rank();
  const int img = blockIdx.x / CLUSTER;
  {
    const int t = threadIdx.x;
    if (t < NBUF) {
      const Layout L = layout(H, W);
      ks.bufs[t] = scratch + (size_t)img * L.total + L.off[t];
    }
    if (t < W_COUNT) ks.off[t] = off.o[t];
    if (t < M_COUNT) ks.moff[t] = moff.o[t];
    if (t == 0) {
      ks.wb = wb;
      ks.wm = wm;
    }
  }
  __syncthreads();
  const Img<T> im{&ks, &stage, sm, rank, H, W};
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;

  // ---- AutoEncoder ----------------------------------------------------
  conv_stage<3, 4, T>(sm, rank, H, W, 3, 12, im.wt(W_AE_CONV_IN_W), nullptr,
                      plain_src<T>(x + (size_t)img * H * W * 3, 3, 0),
                      dst<T>(EP_STORE, im.buf(B_CI), 12, 0));
  stage_barrier();
  dw5_stage<T>(rank, H, W, 12, im.buf(B_CI), im.wt(W_ENC0_DW_W),
               im.wt(W_ENC0_DW_B), im.buf(B_TMP));
  stage_barrier();
  // enc0 pw 12 -> 12, unshuffle to (H/2, W/2, 48), ReLU.
  conv_stage<1, 4, T>(sm, rank, H, W, 12, 12, im.wt(W_ENC0_PW_W),
                      im.wt(W_ENC0_PW_B), plain_src<T>(im.buf(B_TMP), 12, 0),
                      dst<T>(EP_UNSHUFFLE_RELU, im.buf(B_U1), 48, 0));
  stage_barrier();
  dw5_stage<T>(rank, H2, W2, 48, im.buf(B_U1), im.wt(W_ENC1_DW_W),
               im.wt(W_ENC1_DW_B), im.buf(B_TMP));
  stage_barrier();
  // enc1 pw 48 -> 12, unshuffle to (H/4, W/4, 48), ReLU.
  conv_stage<1, 4, T>(sm, rank, H2, W2, 48, 12, im.wt(W_ENC1_PW_W),
                      im.wt(W_ENC1_PW_B), plain_src<T>(im.buf(B_TMP), 48, 0),
                      dst<T>(EP_UNSHUFFLE_RELU, im.buf(B_U2), 48, 0));
  stage_barrier();
  dw5_stage<T>(rank, H4, W4, 48, im.buf(B_U2), im.wt(W_DEC0_DW_W),
               im.wt(W_DEC0_DW_B), im.buf(B_TMP));
  stage_barrier();
  // dec0 pw 48 -> 48, shuffle to (H/2, W/2, 12), ReLU.
  conv_stage<1, 8, T>(sm, rank, H4, W4, 48, 48, im.wt(W_DEC0_PW_W),
                      im.wt(W_DEC0_PW_B), plain_src<T>(im.buf(B_TMP), 48, 0),
                      dst<T>(EP_SHUFFLE_RELU, im.buf(B_S1), 12, 0));
  stage_barrier();
  dw5_stage<T>(rank, H2, W2, 12, im.buf(B_S1), im.wt(W_DEC1_DW_W),
               im.wt(W_DEC1_DW_B), im.buf(B_TMP));
  stage_barrier();
  // dec1 pw 12 -> 48, shuffle to (H, W, 12), ReLU, + conv_in.
  {
    Dst<T> d = dst<T>(EP_SHUFFLE_RELU_ADD, im.buf(B_A), 12, 0);
    d.res = im.buf(B_CI);
    conv_stage<1, 8, T>(sm, rank, H2, W2, 12, 48, im.wt(W_DEC1_PW_W),
                        im.wt(W_DEC1_PW_B),
                        plain_src<T>(im.buf(B_TMP), 12, 0), d);
  }
  stage_barrier();
  conv_stage<3, 3, T>(sm, rank, H, W, 12, 3, im.wt(W_AE_CONV_OUT_W), nullptr,
                      plain_src<T>(im.buf(B_A), 12, 0),
                      dst<T>(EP_STORE, im.buf(B_XB), 3, 0));
  stage_barrier();

  // ---- RDN ------------------------------------------------------------
  conv_stage<7, 8, T>(sm, rank, H, W, 3, 32, im.wt(W_SF1_W), im.wt(W_SF1_B),
                      plain_src<T>(im.buf(B_XB), 3, 0),
                      dst<T>(EP_STORE, im.buf(B_SFE1), 32, 0));
  stage_barrier();
  wide_conv<3, 4, 1, EP_STORE>(im, 32, W_SF2_W, M_SF2,
                               plain_src<T>(im.buf(B_SFE1), 32, 0),
                               dst<T>(EP_STORE, im.buf(B_CAT), 96, 0));
  stage_barrier();
  rdb<T>(im, W_RDB0, M_RDB0, 0);
  // CSAR's output is the next RDB's input: also stored into cat[0:32].
  csar<T>(im, 0, 32, true);
  rdb<T>(im, W_RDB1, M_RDB1, 64);
  csar<T>(im, 64, 96, false);
  wide_conv<1, 4, 1, EP_STORE>(im, 128, W_GFF0_W, M_GFF0,
                               plain_src<T>(im.buf(B_FEATS), 128, 0),
                               dst<T>(EP_STORE, im.buf(B_T32), 32, 0));
  stage_barrier();
  // gff1 3x3 + sfe1 -> xin (free by now).
  {
    Dst<T> d = dst<T>(EP_RESID, im.buf(B_XIN), 32, 0);
    d.res = im.buf(B_SFE1);
    d.res_cs = 32;
    wide_conv<3, 4, 1, EP_RESID>(im, 32, W_GFF1_W, M_GFF1,
                                 plain_src<T>(im.buf(B_T32), 32, 0), d);
  }
  stage_barrier();
  {
    const T* xin = im.buf(B_XIN);
    Dst<T> d = dst<T>(EP_FINAL, (T*)nullptr, 1, 0);
    d.outf = out + (size_t)img * H * W;
    conv_stage<3, 1, T>(sm, rank, H, W, 32, 1, im.wt(W_FINAL_W),
                        im.wt(W_FINAL_B), plain_src<T>(xin, 32, 0), d);
  }
}

template <class T>
int launch(const void* x, const void* wbuf, const int* offsets,
           int n_offsets, const void* wmma, const int* mma_offsets,
           int n_mma, void* scratch, void* out, int n, int h, int w,
           void* stream) {
  if (n_offsets != W_COUNT || n_mma != M_COUNT || n <= 0 || h <= 0 ||
      w <= 0 || h % 4 != 0 || w % 4 != 0 ||
      (long long)n * CLUSTER > 0x7fffffffLL)
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
  // The B tiles (bf16, or TF32 big + small): 16-byte aligned, offsets in
  // multiples of 8 elements.
  MOffsets moff;
  for (int i = 0; i < M_COUNT; ++i) {
    if (mma_offsets[i] < 0 || mma_offsets[i] % 8 != 0)
      return (int)cudaErrorInvalidValue;
    moff.o[i] = mma_offsets[i];
  }
  if (wmma == nullptr || reinterpret_cast<uintptr_t>(wmma) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lpsr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  lpsr_kernel<T><<<n * CLUSTER, NTHREADS, SMEM_BYTES,
                   (cudaStream_t)stream>>>(
      (const T*)x, (const float*)wbuf, off, (const T*)wmma, moff,
      (T*)scratch, (float*)out, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K2 on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  x (n, h, w, 3) in the activation type; wbuf the packed float32
// weights and `offsets` (host memory) their 62 offsets in PACK_KEYS order;
// wmma the wide stages' B tiles in the activation type (bf16, or the
// float32 instance's TF32 big + small) and `mma_offsets` (host memory)
// their 18 offsets in MMA_KEYS order; scratch n *
// lpr_lpsr_scratch_elems(h, w) elements of the activation type; out (n, h,
// w, 1) float32.
extern "C" int lpr_lpsr_bf16(const void* x, const void* wbuf,
                             const int* offsets, int n_offsets,
                             const void* wmma, const int* mma_offsets,
                             int n_mma, void* scratch, void* out, int n,
                             int h, int w, void* stream) {
  return launch<bf16>(x, wbuf, offsets, n_offsets, wmma, mma_offsets, n_mma,
                      scratch, out, n, h, w, stream);
}

extern "C" int lpr_lpsr_f32(const void* x, const void* wbuf,
                            const int* offsets, int n_offsets,
                            const void* wmma, const int* mma_offsets,
                            int n_mma, void* scratch, void* out, int n,
                            int h, int w, void* stream) {
  return launch<float>(x, wbuf, offsets, n_offsets, wmma, mma_offsets, n_mma,
                       scratch, out, n, h, w, stream);
}

// Entries of the B-tile table (MMA_KEYS).
extern "C" int lpr_lpsr_n_mma(void) { return M_COUNT; }

// Scratch elements per image, or -1 for a shape the kernel does not take.
extern "C" long long lpr_lpsr_scratch_elems(int h, int w) {
  if (h <= 0 || w <= 0 || h % 4 != 0 || w % 4 != 0) return -1;
  return layout(h, w).total;
}

// Dynamic shared memory per block, for reports.
extern "C" int lpr_lpsr_smem_bytes(void) { return SMEM_BYTES; }
