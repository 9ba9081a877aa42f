// 5x5 joint bilateral filter of the denoised frame, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this stage outside Pallas
// (raytracingdiffusioncurves_tpu/ops/denoise.py::spatial_bilateral, under
// XLA), and the port ran it as ~256 small PyTorch launches a frame
// (ops/denoise.py::spatial_bilateral_plain: 25 taps of slices, casts and
// elementwise passes over the whole frame); it is the first part of the
// post-processing chain that ROADMAP.md's queue B (item 0) asks for as CUDA
// kernels.  One launch of this kernel computes the same function, bitwise:
//
//   for each pixel p of an (N, H, W, C) float32 image, edges replicate-padded,
//     w(q)   = weight of tap q = (dy, dx) in -2..2, taps dy-major then dx
//     out[p] = (sum_q v[q] * w(q)) / (sum_q w(q))       all C channels
//
// with the weight from colour channels 0-2.  bf16 weights (the default, the
// JAX package's BILATERAL_BF16): every step of the weight chain rounds to
// bf16 as the plain version's bf16 tensors do, each computed in float32 and
// rounded once:
//
//   d_k   = bf16(bf16(n_k) - bf16(c_k))        k = 0, 1, 2
//   s_k   = bf16(d_k * d_k)
//   dist2 = bf16((s_0 + s_1) + s_2)           the plain version's reduction
//                                              order (serial over channels)
//   arg   = bf16(spatial_q - bf16(dist2 * inv_sc))
//   w(q)  = bf16(expf(arg))
//
// (spatial_q and inv_sc are bf16 constants from the caller).  The float32
// branch is the same chain without the roundings.  Values and both sums stay
// float32, every product and sum rounded on its own, in the plain loop's tap
// order; one IEEE division ends it.  Built with --fmad=false, and written
// with the _rn intrinsics besides, so that no multiply and add fuse.
//
// What bounds it on this card.  At 1080x1920 it reads one (H, W, 4) float32
// frame (33.2 MB, through the [..., :3] view) and writes one (H, W, 3) (24.9
// MB): 0.017 ms at 3.35e12 B/s.  Its arithmetic is ~25 FLOP and one expf a
// tap, 25 taps a pixel: ~1.3e9 FLOP, 0.019 ms at 67e12 FP32 FLOP/s.  What
// holds it in practice is instruction throughput, above all the bf16
// roundings: a float-to-bf16 conversion runs at a fraction of the FP32 rate,
// and a scalar chain needs ten a tap (0.16 ms a frame when written so).
//
// Design: one block stages a tile of 32 x 16 output pixels plus its 2-pixel
// apron (36 x 20) into shared memory once, clamping coordinates for the
// replicate padding.  Planes are channel-major, [channel][pixel], so the 32
// threads of a warp read 32 neighbouring words.  Global reads: 16 bytes a
// thread (a whole float4 pixel) where the pixel stride is 4 floats with unit
// channel stride and the base is 16-byte aligned (the main path's [..., :3]
// view of the (H, W, 4) frame, read in place), scalar loads otherwise.  256
// threads; each filters two pixels, A in row ty and its partner B in row
// ty + 8, in lockstep.  The bf16 branch converts the apron's colours to bf16
// once and keeps them as bf16x2 pairs (a pixel and the one 8 rows below), so
// each tap's chain runs for A and B together in packed bf16x2 operations,
// with two conversions a tap instead of twenty.  C > 4 runs the taps once
// per group of 4 channels (weights recomputed: the same values).  The batch
// is the grid's z axis.
//
// Plain C entry, loaded with ctypes (ops/_build.py); launches on the stream
// it is given, allocates nothing, does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int R = 2;                  // radius: a 5x5 window
constexpr int TAPS = (2 * R + 1) * (2 * R + 1);
constexpr int TW = 32;                // output columns per block: one warp's width
constexpr int HALF = 8;               // thread rows; a thread takes rows ty and ty + HALF
constexpr int TH = 2 * HALF;          // output rows per block
constexpr int THREADS = TW * HALF;
constexpr int AW = TW + 2 * R;        // apron tile
constexpr int AH = TH + 2 * R;
constexpr int TILE_PX = AW * AH;
constexpr int PAIR = HALF * AW;       // from a pixel of the apron to its partner, HALF rows down
constexpr int PAIR_PX = TILE_PX - PAIR;  // apron pixels that have a partner
constexpr int MAX_C = 8;              // channels a call may have (shared memory)

struct Params {
  const float* in;
  float* out;                         // (n, h, w, c) contiguous
  int n, h, w, c;
  long long s_n, s_y, s_x, s_c;       // input strides, in elements
  int vec4;                           // stage whole pixels as float4
  float inv_sc;
  float spatial[TAPS];                // per tap, dy-major
  uint32_t inv_sc2;                   // the bf16 branch's constants as bf16x2 pairs
  uint32_t spatial2[TAPS];
};

// bf16x2 arithmetic: each half is the exact result rounded once to bf16 (an
// fma with -1 or -0).  The plain version computes these steps in float32
// and rounds to bf16: the same value, because a product of two bf16 values
// is exact in float32, and a difference of two is exact unless their
// exponents differ by more than 16, and then lies too far from a bf16
// midpoint for the two roundings to part.
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("{.reg .b32 m;\n\tmov.b32 m, 0xbf80bf80;\n\tfma.rn.bf16x2 %0, %2, m, %1;\n\t}"
      : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("{.reg .b32 z;\n\tmov.b32 z, 0x80008000;\n\tfma.rn.bf16x2 %0, %1, %2, z;\n\t}"
      : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two floats rounded to bf16 (nearest even) into one pair: lo, hi.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ float lo_of(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_of(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// The float32 branch's weight of one tap.  The squared distance sums in the
// plain version's order: its reduction runs serially over the channel axis
// of its channel-major temporaries.
__device__ __forceinline__ float weight_f32(float n0, float n1, float n2, float c0, float c1,
                                            float c2, float spatial, float inv_sc) {
  const float d0 = __fsub_rn(n0, c0), d1 = __fsub_rn(n1, c1), d2 = __fsub_rn(n2, c2);
  const float dist2 =
      __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
  return expf(__fsub_rn(spatial, __fmul_rn(dist2, inv_sc)));
}

// Both pixels' weights of tap t: pixel A (lo) and its partner B (hi).  The
// bf16 branch reads the colour pairs gp (j: A's neighbour) and the centre
// pairs cp; the float32 branch the value planes v.
template <bool BF16>
__device__ __forceinline__ float2 tap_weights(float spatial, float inv_sc, uint32_t spatial2,
                                              uint32_t inv_sc2, const uint32_t* gp,
                                              const uint32_t* cp, const float* v, int j,
                                              int ci) {
  if constexpr (BF16) {
    float s[2];
    uint32_t q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t d = bsub2(gp[k * PAIR_PX + j], cp[k]);
      q[k] = bmul2(d, d);
    }
    s[0] = __fadd_rn(__fadd_rn(lo_of(q[0]), lo_of(q[1])), lo_of(q[2]));
    s[1] = __fadd_rn(__fadd_rn(hi_of(q[0]), hi_of(q[1])), hi_of(q[2]));
    const uint32_t arg = bsub2(spatial2, bmul2(pack_rn(s[0], s[1]), inv_sc2));
    const uint32_t w = pack_rn(expf(lo_of(arg)), expf(hi_of(arg)));
    return make_float2(lo_of(w), hi_of(w));
  } else {
    const float wa = weight_f32(v[j], v[TILE_PX + j], v[2 * TILE_PX + j], v[ci],
                                v[TILE_PX + ci], v[2 * TILE_PX + ci], spatial, inv_sc);
    const int jb = j + PAIR, cb = ci + PAIR;
    const float wb = weight_f32(v[jb], v[TILE_PX + jb], v[2 * TILE_PX + jb], v[cb],
                                v[TILE_PX + cb], v[2 * TILE_PX + cb], spatial, inv_sc);
    return make_float2(wa, wb);
  }
}

// CG: channels a pass over the taps accumulates (3, or 4 with the rest
// predicated).
template <bool BF16, int CG>
__global__ void __launch_bounds__(THREADS) bilateral5x5_kernel(const Params p) {
  extern __shared__ float smem[];
  float* v = smem;                                     // [c][TILE_PX] values
  uint32_t* gp = reinterpret_cast<uint32_t*>(v + p.c * TILE_PX);  // [3][PAIR_PX] bf16 pairs
  uint16_t* gb = reinterpret_cast<uint16_t*>(gp + 3 * PAIR_PX);  // [3][TILE_PX] bf16 bits
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const float* in = p.in + b * p.s_n;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < TILE_PX; i += THREADS) {
    const int y = min(max(y0 + i / AW - R, 0), p.h - 1);
    const int x = min(max(x0 + i % AW - R, 0), p.w - 1);
    const float* px = in + y * p.s_y + x * p.s_x;
    if (p.vec4) {
      const float4 q = *reinterpret_cast<const float4*>(px);
      const float vals[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < p.c) v[k * TILE_PX + i] = vals[k];
    } else {
      for (int k = 0; k < p.c; ++k) v[k * TILE_PX + i] = px[k * p.s_c];
    }
    if constexpr (BF16) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gb[k * TILE_PX + i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k * TILE_PX + i]));
    }
  }
  __syncthreads();
  if constexpr (BF16) {
    for (int i = tid; i < PAIR_PX; i += THREADS) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gp[k * PAIR_PX + i] = gb[k * TILE_PX + i] | (uint32_t)gb[k * TILE_PX + i + PAIR] << 16;
    }
    __syncthreads();
  }

  const int x = x0 + threadIdx.x;
  const int ya = y0 + threadIdx.y, yb = ya + HALF;
  const int ci = (threadIdx.y + R) * AW + threadIdx.x + R;  // pixel A; B is ci + PAIR
  uint32_t cp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) cp[k] = BF16 ? gp[k * PAIR_PX + ci] : 0u;
  float* out_a = p.out + (((long long)b * p.h + ya) * p.w + x) * p.c;
  float* out_b = out_a + (long long)HALF * p.w * p.c;
#pragma unroll 1
  for (int k0 = 0; k0 < p.c; k0 += CG) {
    float acc_a[CG], acc_b[CG];
#pragma unroll
    for (int k = 0; k < CG; ++k) acc_a[k] = acc_b[k] = 0.0f;
    float ws_a = 0.0f, ws_b = 0.0f;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int j = ci + (t / (2 * R + 1) - R) * AW + (t % (2 * R + 1) - R);
      const float2 w = tap_weights<BF16>(p.spatial[t], p.inv_sc, p.spatial2[t], p.inv_sc2, gp,
                                         cp, v, j, ci);
#pragma unroll
      for (int k = 0; k < CG; ++k) {
        if (k0 + k < p.c) {
          const float* vk = v + (k0 + k) * TILE_PX;
          acc_a[k] = __fadd_rn(acc_a[k], __fmul_rn(vk[j], w.x));
          acc_b[k] = __fadd_rn(acc_b[k], __fmul_rn(vk[j + PAIR], w.y));
        }
      }
      ws_a = __fadd_rn(ws_a, w.x);
      ws_b = __fadd_rn(ws_b, w.y);
    }
    if (x < p.w) {
#pragma unroll
      for (int k = 0; k < CG; ++k) {
        if (k0 + k < p.c) {
          if (ya < p.h) out_a[k0 + k] = __fdiv_rn(acc_a[k], ws_a);
          if (yb < p.h) out_b[k0 + k] = __fdiv_rn(acc_b[k], ws_b);
        }
      }
    }
  }
}

uint32_t bf16_pair(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return (u >> 16) | (u & 0xffff0000u);
}

bool bf16_exact(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return (u & 0xffffu) == 0;
}

template <bool BF16, int CG>
void launch(const Params& P, cudaStream_t s) {
  const dim3 grid((P.w + TW - 1) / TW, (P.h + TH - 1) / TH, P.n);
  const dim3 block(TW, HALF);
  const size_t smem = (size_t)P.c * TILE_PX * sizeof(float) +
                      (BF16 ? 3 * PAIR_PX * sizeof(uint32_t) + 3 * TILE_PX * sizeof(uint16_t) : 0);
  bilateral5x5_kernel<BF16, CG><<<grid, block, smem, s>>>(P);
}

}  // namespace

extern "C" int rtdc_bilateral5x5(const void* in, void* out, int n, int h, int w, int c,
                                 long long s_n, long long s_y, long long s_x, long long s_c,
                                 int vec4, const float* spatial, float inv_sc, int bf16,
                                 void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || c < 3 || c > MAX_C || spatial == nullptr ||
      (vec4 && (c > 4 || s_x != 4 || s_c != 1 || (reinterpret_cast<uintptr_t>(in) & 15) ||
                s_y % 4 || (n > 1 && s_n % 4))))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.in = static_cast<const float*>(in);
  P.out = static_cast<float*>(out);
  P.n = n, P.h = h, P.w = w, P.c = c;
  P.s_n = s_n, P.s_y = s_y, P.s_x = s_x, P.s_c = s_c;
  P.vec4 = vec4;
  P.inv_sc = inv_sc;
  P.inv_sc2 = bf16_pair(inv_sc);
  bool exact = bf16_exact(inv_sc);
  for (int t = 0; t < TAPS; ++t) {
    P.spatial[t] = spatial[t];
    P.spatial2[t] = bf16_pair(spatial[t]);
    exact = exact && bf16_exact(spatial[t]);
  }
  if (bf16 && !exact) return (int)cudaErrorInvalidValue;  // the bf16 chain takes bf16 constants
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    c == 3 ? launch<true, 3>(P, s) : launch<true, 4>(P, s);
  else
    c == 3 ? launch<false, 3>(P, s) : launch<false, 4>(P, s);
  return (int)cudaGetLastError();
}

extern "C" const char* rtdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
