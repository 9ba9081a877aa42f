// 3x3 convolution of the denoiser networks, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's two Pallas TPU kernels
//   raytracingdiffusioncurves_tpu/ops/conv_pallas.py::_flat_kernel  (conv3x3_flat)
//   raytracingdiffusioncurves_tpu/ops/conv_pallas.py::_conv_kernel  (conv3x3_same)
// with one kernel.  What it computes, for one NHWC bf16 image:
//
//   y = relu?( bf16( sum_groups sum_taps x_g (*) k_g ) + bias_bf16 )
//
// 1 to 3 input groups (a channel concat is extra groups, never a copy), HWIO
// bf16 weights, stride 1 or 2 with the SAME padding the caller hands over,
// float32 accumulation, the accumulator rounded to bf16 (nearest even) BEFORE
// the bf16 bias is added, that sum rounded to bf16 again, optional ReLU.
// Taps outside the image read zero by predicate: no padded ring, no guard
// rows, no mask input, no channel padding.  A group may be read through a
// nearest 2x upsample (x[i >> 1, j >> 1]), so the decoder never writes an
// upsampled tensor.  A bf16 x bf16 product is exact in float32, so the only
// freedom against the plain PyTorch version (ops/conv_cuda.py
// conv3x3_plain) is the order of the float32 sum.
//
// Bound on this card: bytes.  The nine layers of the shipped UNet at
// 1920x1088 need ~1.15e11 multiply-adds against ~1.2 GB moved; at the dense
// bf16 tensor-core rate the multiply-adds take less time than the bytes at
// the memory rate, and both well under a millisecond.  Layer by layer only
// the two with the most channels per byte moved (enc2b, 96 -> 96, and dec1,
// 96 + 48 -> 48 with the first group read through the upsample) are bound
// by operations.  This first version is far from either bound: it is a
// direct convolution on the FP32 pipes.  One block
// computes a tile of 32 x (4 * PX) output pixels for CO_T output channels.
// The input halo tile (8 channels at a time, bf16) and that chunk's weights
// (float32) are staged in shared memory; a thread owns PX vertically adjacent
// pixels of one column and CO_T channels, all in registers, so one input
// value feeds up to 3 * CO_T FMAs and one broadcast float4 of weights 4 * PX.
// Lanes of a warp read neighbouring columns: no bank conflicts at stride 1.
// Tensor-core MMA, TMA staging and fusing layers are later work.
//
// Plain C entry, loaded with ctypes (ops/_build.py); launches on the stream
// it is given, allocates nothing, does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TW = 32;        // output columns per block: one per lane
constexpr int CK = 8;         // input channels staged per step (16 bytes of bf16)
constexpr int MAX_GROUPS = 3;

struct Group {
  const uint16_t* x;  // (h_in >> shift, w_in >> shift, cin) bf16 bits
  const uint16_t* k;  // (3, 3, cin, cout) bf16 bits
  int cin;
  int shift;          // 1: read through a nearest 2x upsample
};

struct Params {
  Group g[MAX_GROUPS];
  int n_groups;
  const uint16_t* bias;  // (cout,) bf16 bits
  uint16_t* out;         // (h_out, w_out, cout) bf16 bits
  int h_in, w_in;        // input size as the taps see it (after any upsample)
  int h_out, w_out, cout;
  int pad_top, pad_left;
  int relu;
};

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(((uint32_t)b) << 16);
}

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int CO_T, int PX, int S>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(const Params P) {
  constexpr int TH = WARPS * PX;          // output rows per block
  constexpr int IN_H = (TH - 1) * S + 3;  // input halo tile
  constexpr int IN_W = (TW - 1) * S + 3;
  constexpr int NR = (PX - 1) * S + 3;    // input rows one thread touches
  static_assert(CO_T % 4 == 0, "weights are read as float4");

  __shared__ uint16_t xs[CK][IN_H][IN_W];
  __shared__ __align__(16) float ws[9][CK][CO_T];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ox = blockIdx.x * TW + lane;
  const int oy0 = blockIdx.y * TH + warp * PX;
  const int co0 = blockIdx.z * CO_T;
  const int in_r0 = blockIdx.y * TH * S - P.pad_top;
  const int in_c0 = blockIdx.x * TW * S - P.pad_left;

  float acc[PX][CO_T];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[p][c] = 0.0f;

  for (int gi = 0; gi < P.n_groups; ++gi) {
    const Group G = P.g[gi];
    const int src_w = P.w_in >> G.shift;
    // 16-byte loads need whole 8-channel steps at 16-byte aligned addresses.
    const bool vec = (G.cin % CK == 0) && ((reinterpret_cast<uintptr_t>(G.x) & 15) == 0);
    for (int ci0 = 0; ci0 < G.cin; ci0 += CK) {
      const int ckn = min(CK, G.cin - ci0);
      __syncthreads();  // the previous step's reads of xs and ws are done
      for (int i = threadIdx.x; i < IN_H * IN_W; i += THREADS) {
        const int r = i / IN_W, c = i - r * IN_W;
        const int gr = in_r0 + r, gc = in_c0 + c;
        union {
          uint4 v;
          uint16_t h[CK];
        } u;
        u.v = make_uint4(0u, 0u, 0u, 0u);
        if (gr >= 0 && gr < P.h_in && gc >= 0 && gc < P.w_in) {
          const uint16_t* src =
              G.x + ((size_t)(gr >> G.shift) * src_w + (gc >> G.shift)) * G.cin + ci0;
          if (vec) {
            u.v = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            for (int j = 0; j < ckn; ++j) u.h[j] = __ldg(src + j);
          }
        }
#pragma unroll
        for (int j = 0; j < CK; ++j) xs[j][r][c] = u.h[j];
      }
      for (int i = threadIdx.x; i < 9 * CK * CO_T; i += THREADS) {
        const int c = i % CO_T;
        const int t = i / CO_T;
        const int ci = t % CK, tap = t / CK;
        float v = 0.0f;
        if (ci < ckn && co0 + c < P.cout)
          v = bf16_bits_to_float(__ldg(G.k + ((size_t)tap * G.cin + ci0 + ci) * P.cout + co0 + c));
        ws[tap][ci][c] = v;
      }
      __syncthreads();

#pragma unroll 1
      for (int ci = 0; ci < ckn; ++ci) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xr[NR];
#pragma unroll
          for (int r = 0; r < NR; ++r)
            xr[r] = bf16_bits_to_float(xs[ci][warp * PX * S + r][lane * S + dx]);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float4* w4 = reinterpret_cast<const float4*>(&ws[dy * 3 + dx][ci][0]);
#pragma unroll
            for (int c4 = 0; c4 < CO_T / 4; ++c4) {
              const float4 w = w4[c4];
#pragma unroll
              for (int p = 0; p < PX; ++p) {
                const float x = xr[p * S + dy];
                acc[p][c4 * 4 + 0] = fmaf(x, w.x, acc[p][c4 * 4 + 0]);
                acc[p][c4 * 4 + 1] = fmaf(x, w.y, acc[p][c4 * 4 + 1]);
                acc[p][c4 * 4 + 2] = fmaf(x, w.z, acc[p][c4 * 4 + 2]);
                acc[p][c4 * 4 + 3] = fmaf(x, w.w, acc[p][c4 * 4 + 3]);
              }
            }
          }
        }
      }
    }
  }

  // Epilogue: round the accumulator to bf16, add the bf16 bias (the sum of
  // two bf16 values in float32, rounded to bf16, is the bf16 add), ReLU.
  if (ox >= P.w_out) return;
  const bool vec_out = (P.cout % 8 == 0) && ((reinterpret_cast<uintptr_t>(P.out) & 15) == 0);
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int oy = oy0 + p;
    if (oy >= P.h_out) break;
    uint16_t* dst = P.out + ((size_t)oy * P.w_out + ox) * P.cout + co0;
#pragma unroll
    for (int c8 = 0; c8 < CO_T; c8 += 8) {
      union {
        uint4 v;
        uint16_t h[8];
      } y;
      y.v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c8 + j;
        if (c < CO_T && co0 + c < P.cout) {
          const float b = bf16_bits_to_float(__ldg(P.bias + co0 + c));
          float v = round_to_bf16(round_to_bf16(acc[p][c]) + b);
          if (P.relu) v = fmaxf(v, 0.0f);
          y.h[j] = float_to_bf16_bits(v);
        }
      }
      if (vec_out && co0 + c8 + 8 <= P.cout) {
        *reinterpret_cast<uint4*>(dst + c8) = y.v;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c8 + j < CO_T && co0 + c8 + j < P.cout) dst[c8 + j] = y.h[j];
      }
    }
  }
}

template <int CO_T, int PX, int S>
int launch(const Params& P, cudaStream_t stream) {
  constexpr int TH = WARPS * PX;
  dim3 grid((P.w_out + TW - 1) / TW, (P.h_out + TH - 1) / TH, (P.cout + CO_T - 1) / CO_T);
  conv3x3_kernel<CO_T, PX, S><<<grid, THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}

template <int S>
int dispatch(const Params& P, cudaStream_t stream) {
  // Tile of output channels and pixels a thread keeps in registers (96
  // accumulators at most): narrow outputs take 4 channels, widths that are a
  // multiple of 48 take 48 x 2 pixels, everything else 24 x 4 pixels.
  if (P.cout <= 4) return launch<4, 4, S>(P, stream);
  if (P.cout % 48 == 0) return launch<48, 2, S>(P, stream);
  return launch<24, 4, S>(P, stream);
}

}  // namespace

// Launch one convolution on `stream`.  Returns the cudaError of the launch
// (0 = launched); cudaErrorInvalidValue for arguments the kernel does not
// take.  Shapes, types and contiguity are the caller's to check.
extern "C" int rtdc_conv3x3(const void* x0, const void* x1, const void* x2,
                            const void* k0, const void* k1, const void* k2,
                            int cin0, int cin1, int cin2,
                            int up0, int up1, int up2, int n_groups,
                            const void* bias, void* out,
                            int h_in, int w_in, int h_out, int w_out, int cout,
                            int stride, int pad_top, int pad_left, int relu,
                            void* stream) {
  if (n_groups < 1 || n_groups > MAX_GROUPS || (stride != 1 && stride != 2) || cout < 1 ||
      h_out < 1 || w_out < 1)
    return (int)cudaErrorInvalidValue;
  Params P;
  const void* xs[MAX_GROUPS] = {x0, x1, x2};
  const void* ks[MAX_GROUPS] = {k0, k1, k2};
  const int cins[MAX_GROUPS] = {cin0, cin1, cin2};
  const int ups[MAX_GROUPS] = {up0, up1, up2};
  for (int i = 0; i < MAX_GROUPS; ++i) {
    P.g[i].x = static_cast<const uint16_t*>(xs[i]);
    P.g[i].k = static_cast<const uint16_t*>(ks[i]);
    P.g[i].cin = cins[i];
    P.g[i].shift = ups[i] ? 1 : 0;
    if (i < n_groups && (xs[i] == nullptr || ks[i] == nullptr || cins[i] < 1))
      return (int)cudaErrorInvalidValue;
  }
  P.n_groups = n_groups;
  P.bias = static_cast<const uint16_t*>(bias);
  P.out = static_cast<uint16_t*>(out);
  P.h_in = h_in;
  P.w_in = w_in;
  P.h_out = h_out;
  P.w_out = w_out;
  P.cout = cout;
  P.pad_top = pad_top;
  P.pad_left = pad_left;
  P.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stride == 1 ? dispatch<1>(P, s) : dispatch<2>(P, s);
}

extern "C" const char* rtdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
