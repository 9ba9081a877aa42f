// Variable-sigma separable Gaussian blur of the frame, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this stage outside Pallas
// (raytracingdiffusioncurves_tpu/ops/blur.py, under XLA), and the port ran it
// as ~218 small PyTorch launches a frame (ops/blur.py::_variable_gauss_1d:
// two index_selects, a where and five elementwise passes over the whole
// frame per tap, six taps at radius 6, two passes).  One launch of this
// kernel computes the same function, bitwise:
//
//   horizontal pass over every row of the (h_in, w, c) input, then the
//   vertical pass over the output rows [top, h_in - bottom); each tap's
//   neighbours clamped to the input's edges, each pass reading the sigma
//   of its own output pixel s:
//
//     sig = s + 1e-6;  inv = 1 / (sig * sig);  k_half = ceil(3 s)
//     e1 = expf(-inv);  e2 = e1 e1;  g = e1;  m = e1 e2
//     acc = x[0];  wsum = 1
//     for k = 1 .. radius:
//       gk = k <= k_half ? g : 0
//       acc = acc + (x[+k] + x[-k]) gk       each channel
//       wsum = wsum + 2 gk;  g = g m;  m = m e2
//     out = acc / wsum                       each channel
//
// every product and sum rounded on its own, in the plain loop's order (built
// with --fmad=false, and written with the _rn intrinsics besides); expf, not
// __expf, as PyTorch's exp; IEEE divisions.
//
// What bounds it on this card.  At 1080x1920 it reads one (H, W, 4) float32
// frame (33.2 MB) and the sigma map (8.3 MB) and writes one frame (33.2 MB):
// 0.022 ms at 3.35e12 B/s.  Its arithmetic, per pixel and pass, is one expf,
// five IEEE divisions and ~17 FP32 operations a tap: ~160 instructions at
// radius 6, ~0.8e9 a frame with the halo rows' horizontal pass (0.03 ms at
// the card's FP32 instruction rate), of the same order as the bytes' time.
//
// Design: one block owns an output tile of TW x TH pixels.  It runs the
// horizontal pass for the input rows the tile's vertical taps reach (its
// rows plus `radius` above and below, cut at the input's edges), reading
// the input's pixels straight from global memory (as float4 where the
// strides allow: 4-float pixels of unit channel stride, 16-byte aligned),
// and keeps the result in shared memory as float4 pixels; after one barrier
// it runs the vertical pass from shared memory and writes the tile (float4
// where C = 4).  The intermediate frame never goes to device memory.  The
// tile is 32 columns by 64 rows (at radius 6 on the 1080p frame 0.078 ms,
// as 32 rows; 8 or 16 rows are slower, 0.113 and 0.089; at radius 24 it
// reads 0.28 ms against 0.40 with 32 rows); its height and then its width
// are halved until the staged rows fit in a block's shared memory (they are
// never more than the input's rows), so any radius runs on an input of up
// to 14,528 rows.  C <= 4 channels (unused lanes compute zeros and are not
// stored).
//
// Plain C entry, loaded with ctypes (ops/_build.py); launches on the stream
// it is given, allocates nothing, does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_W = 32;                   // the widest tile: one warp across
constexpr int TILE_H = 64;                   // halved where the rows do not fit
constexpr size_t SMEM_MAX = 227 * 1024;      // a block's dynamic shared memory
constexpr size_t SMEM_DEFAULT = 48 * 1024;   // above this only after an opt-in
constexpr int MAX_C = 4;

struct Params {
  const float* in;
  const float* sigma;
  float* out;                 // (h_out, w, c) contiguous
  int h_in, w, c, radius, top, h_out;
  long long s_y, s_x, s_c;    // the image's strides, in elements
  long long g_y, g_x;         // the sigma map's strides
  int vec4_in, vec4_out;      // 16-byte pixel loads, stores
  int tw, th;                 // the tile
};

__device__ __forceinline__ float4 load_px(const Params& p, int y, int x) {
  const float* px = p.in + y * p.s_y + x * p.s_x;
  if (p.vec4_in) return __ldg(reinterpret_cast<const float4*>(px));
  float v[MAX_C] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < MAX_C; ++k)
    if (k < p.c) v[k] = __ldg(px + k * p.s_c);
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// One pixel of one pass: ``pair(k)`` gives x[+k] + x[-k].
template <class Pair>
__device__ __forceinline__ float4 blur_px(float4 acc, float s, int radius, Pair pair) {
  const float sig = __fadd_rn(s, 1e-6f);
  const float inv = __fdiv_rn(1.0f, __fmul_rn(sig, sig));
  const float k_half = ceilf(__fmul_rn(3.0f, s));
  const float e1 = expf(-inv);
  const float e2 = __fmul_rn(e1, e1);
  float g = e1, m = __fmul_rn(e1, e2), wsum = 1.0f;
#pragma unroll 2
  for (int k = 1; k <= radius; ++k) {
    const float gk = (float)k <= k_half ? g : 0.0f;
    const float4 v = pair(k);
    acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, gk));
    acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, gk));
    acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, gk));
    acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, gk));
    wsum = __fadd_rn(wsum, __fmul_rn(2.0f, gk));
    g = __fmul_rn(g, m);
    m = __fmul_rn(m, e2);
  }
  return make_float4(__fdiv_rn(acc.x, wsum), __fdiv_rn(acc.y, wsum), __fdiv_rn(acc.z, wsum),
                     __fdiv_rn(acc.w, wsum));
}

__global__ void __launch_bounds__(THREADS) variable_blur_kernel(const Params p) {
  extern __shared__ float4 rows[];  // [input row - ra][column - x0]: the horizontal pass
  const int tw = p.tw;
  const int x0 = blockIdx.x * tw, y0 = blockIdx.y * p.th;  // y0: an output row
  const int y1 = min(y0 + p.th, p.h_out);
  const int reach = min(p.radius, p.h_in);
  const int ra = max(p.top + y0 - reach, 0);                // input rows [ra, rb)
  const int rb = min(p.top + y1 + reach, p.h_in);

  for (int i = threadIdx.x; i < (rb - ra) * tw; i += THREADS) {
    const int r = ra + i / tw, x = x0 + i % tw;
    if (x >= p.w) continue;
    rows[i] = blur_px(load_px(p, r, x), p.sigma[r * p.g_y + x * p.g_x], p.radius, [&](int k) {
      return add4(load_px(p, r, min(x + k, p.w - 1)), load_px(p, r, max(x - k, 0)));
    });
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (y1 - y0) * tw; i += THREADS) {
    const int col = i % tw, x = x0 + col;
    if (x >= p.w) continue;
    const int y = y0 + i / tw, r = p.top + y;
    const float4 v = blur_px(rows[(r - ra) * tw + col], p.sigma[r * p.g_y + x * p.g_x],
                             p.radius, [&](int k) {
      return add4(rows[(min(r + k, p.h_in - 1) - ra) * tw + col],
                  rows[(max(r - k, 0) - ra) * tw + col]);
    });
    float* o = p.out + ((long long)y * p.w + x) * p.c;
    if (p.vec4_out) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vals[MAX_C] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < MAX_C; ++k)
        if (k < p.c) o[k] = vals[k];
    }
  }
}

// Shared memory of a tile: the input rows its vertical taps reach.
size_t tile_bytes(int h_in, int radius, int tw, int th) {
  const long long rows = (long long)th + 2LL * radius;
  return (size_t)(rows < h_in ? rows : h_in) * tw * sizeof(float4);
}

}  // namespace

extern "C" int rtdc_variable_blur(const void* in, const void* sigma, void* out, int h_in, int w,
                                  int c, int radius, int top, int h_out, long long s_y,
                                  long long s_x, long long s_c, long long g_y, long long g_x,
                                  void* stream) {
  if (h_in < 1 || w < 1 || c < 1 || c > MAX_C || radius < 0 || radius > (1 << 30) ||
      top < 0 || h_out < 1 || top + h_out > h_in || in == nullptr || sigma == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.in = static_cast<const float*>(in);
  P.sigma = static_cast<const float*>(sigma);
  P.out = static_cast<float*>(out);
  P.h_in = h_in, P.w = w, P.c = c, P.radius = radius, P.top = top, P.h_out = h_out;
  P.s_y = s_y, P.s_x = s_x, P.s_c = s_c, P.g_y = g_y, P.g_x = g_x;
  P.vec4_in = c == 4 && s_c == 1 && s_x == 4 && s_y % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  P.vec4_out = c == 4 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  P.tw = TILE_W, P.th = TILE_H;
  while (tile_bytes(h_in, radius, P.tw, P.th) > SMEM_MAX) {
    if (P.th > 1)
      P.th /= 2;
    else if (P.tw > 1)
      P.tw /= 2;
    else
      return (int)cudaErrorInvalidValue;  // one column of the input's rows does not fit
  }
  const dim3 grid((w + P.tw - 1) / P.tw, (h_out + P.th - 1) / P.th);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_bytes(h_in, radius, P.tw, P.th);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        variable_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  variable_blur_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char* rtdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
