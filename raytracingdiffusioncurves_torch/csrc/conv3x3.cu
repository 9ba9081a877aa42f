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
// rows, no mask input, no channel padding in memory.  A group may be read
// through a nearest 2x upsample (x[i >> 1, j >> 1]), so the decoder never
// writes an upsampled tensor.  A bf16 x bf16 product is exact in float32, so
// the only freedom against the plain PyTorch version (ops/conv_cuda.py
// conv3x3_plain) is the order of the float32 sum.
//
// What bounds it on this card.  The nine layers of the shipped UNet at
// 1920x1088 move ~1.2 GB and do 2.3e11 FLOP: 0.36 ms at 3.35 TB/s against
// 0.23 ms at the bf16 tensor-core rate (989e12/s).  Per layer, the larger of
// the two (ms; B bytes, F operations):
//   enc0a 11 -> 24          0.044 B     enc2a 48 -> 96, stride 2   0.022 B
//   enc0b 24 -> 24          0.060 B     enc2b 96 -> 96 at 1/4      0.022 F
//   enc1a 24 -> 48, str. 2  0.045 B     dec1  up(96) + 48 -> 48    0.066 F
//   enc1b 48 -> 48 at 1/2   0.030 B     dec0  up(48) + 24 -> 24    0.075 B
//   out   24 -> 3           0.034 B
// On the FP32 pipes (67e12/s) the same FLOP take 3.4 ms, about ten times
// the bytes: so the multiply-adds run on the tensor cores, a tile's input (with
// its halo) is staged once for all of Cout, and the output is written once,
// 16 bytes at a time.
//
// Design: an implicit GEMM on `mma.sync.m16n8k16` (bf16 in, f32 out).
//   M = output pixels of a block's tile, TH rows x 16 columns; one m16
//       fragment is 16 neighbouring pixels of one output row.
//   N = all of Cout in one block, padded to NP (8, 24, 32, 48, 96) with zero
//       weights, so a tile's input is staged once, not once per slice of
//       Cout.  Only Cout > 96 walks 96-channel slices over blockIdx.z.
//   K = sum over groups of 9 taps x Cin, walked as (group, 16-channel
//       chunk, tap).  A chunk's halo tile sits in shared memory as
//       [2][rows][cols][8 x bf16]: `ldmatrix.x4` takes one 16-byte pixel
//       row per thread, so the tap offset, the stride-2 step and the >> 1 of
//       an upsampled group are all in the address and no im2col is written.
//       At stride 1 the eight rows of one 8x8 matrix are eight neighbouring
//       pixels, 128 contiguous bytes: free of bank conflicts.  The chunk's
//       weights are the K x N tile [9][16][PITCH] bf16, read with
//       `ldmatrix.x4.trans`; PITCH is an odd number of 16-byte units, so
//       their rows fall into eight different bank groups.
// Staging: `cp.async` global -> shared (16-byte copies where a group's Cin
// is a multiple of 8 and its base is 16-byte aligned; plain loads
// otherwise, e.g. Cin 11, 28 and 44 or storage at an unaligned offset),
// zero-filled at the image edge and past Cin, double-buffered: chunk c + 1
// loads while chunk c's MMAs run.  An upsampled group stages its half-size
// tile only.  Epilogue: the fragments go through the rounding above into a
// shared tile, from which each thread writes 16 contiguous bytes of a
// pixel's channels (scalar stores where Cout is not a multiple of 8).
// Tiles: 4 warps; a warp owns WM m16 rows and all of N (WM = 4 up to NP 48,
// 2 above), so a thread keeps at most 96 accumulators; the two tiles that
// do at stride 1 are held to 168 registers, so three blocks share an SM.
//
// Plain C entry, loaded with ctypes (ops/_build.py); launches on the stream
// it is given, allocates nothing, does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TW = 16;        // output columns per block: the m16 of one fragment
constexpr int CK = 16;        // input channels per K chunk: the k16 of one MMA
constexpr int STAGES = 2;     // chunks in flight in shared memory
constexpr int MAX_GROUPS = 3;
constexpr int SMEM_PER_SM = 233472;  // an H100 SM's shared memory; 1 KB of it per block is reserved

struct Group {
  const uint16_t* x;  // (h_in >> shift, w_in >> shift, cin) bf16 bits
  const uint16_t* k;  // (3, 3, cin, cout) bf16 bits
  int cin;
  int shift;          // 1: read through a nearest 2x upsample
  int chunk_end;      // K chunks of this group and the ones before it
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

// Shapes of one instantiation: NP padded output channels, stride S.
template <int NP, int S>
struct Tile {
  static constexpr int NT = NP / 8;                  // n8 fragments
  static constexpr int WM = NP <= 48 ? 4 : 2;        // m16 rows per warp
  static constexpr int TH = WARPS * WM;              // output rows per block
  static constexpr int IN_H = (TH - 1) * S + 3;      // halo tile
  static constexpr int IN_W = (TW - 1) * S + 3;
  static constexpr int PITCH = NP % 16 == 8 ? NP : NP + 8;  // odd 16-byte units
  static constexpr int X_ELEMS = 2 * IN_H * IN_W * 8;
  static constexpr int W_ELEMS = 9 * CK * PITCH;
  static constexpr int STAGE_ELEMS = X_ELEMS + W_ELEMS;
  static constexpr int OUT_ELEMS = TH * TW * PITCH;
  static constexpr int SMEM_BYTES =
      2 * (STAGES * STAGE_ELEMS > OUT_ELEMS ? STAGES * STAGE_ELEMS : OUT_ELEMS);
  // The tiles with 96 accumulators per thread at stride 1 (NP 48 and 96)
  // fit three blocks on an SM by shared memory; left to itself ptxas may
  // give them a few registers over 168 and so lose a third of the blocks
  // (enc1b, enc2b, dec1).  They are built with a bound of three blocks.
  // Any bound, even of one block, makes ptxas spend registers up to it, so
  // the other tiles are built without one.
  static constexpr bool THREE_BLOCKS = S == 1 && WM * NT == 24;
  static_assert(!THREE_BLOCKS || 3 * (SMEM_BYTES + 1024) <= SMEM_PER_SM, "three blocks fit");
  static_assert(NP % 8 == 0, "N is whole n8 fragments");
};

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(((uint32_t)b) << 16);
}

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared; !ok writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ Group group_of(const Params& P, int gi) {
  return gi == 0 ? P.g[0] : (gi == 1 ? P.g[1] : P.g[2]);
}

// Whether a group's input can be staged by 16-byte copies: Cin a multiple
// of 8 and the base pointer 16-byte aligned.  Otherwise plain loads.
__device__ __forceinline__ bool copies16(const void* p, int cin) {
  return cin % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Stage K chunk `chunk` (its group's halo tile and its weights) into `xs`,
// `ws`: cp.async where the layout allows, plain loads otherwise.
template <int NP, int S>
__device__ __forceinline__ void load_chunk(const Params& P, int chunk, uint16_t* xs, uint16_t* ws,
                                           int in_r0, int in_c0, int n0) {
  using T = Tile<NP, S>;
  int gi = 0;
  while (gi + 1 < P.n_groups && chunk >= group_of(P, gi).chunk_end) ++gi;
  const Group G = group_of(P, gi);
  const int ci0 = (chunk - (gi == 0 ? 0 : group_of(P, gi - 1).chunk_end)) * CK;

  // Halo tile of the source image: rows and columns as stored (half size
  // for an upsampled group), zero outside the image and past Cin.
  const int s = G.shift;
  const int src_h = P.h_in >> s, src_w = P.w_in >> s;
  const int r0 = in_r0 >> s, c0 = in_c0 >> s;
  const int rh = ((in_r0 + T::IN_H - 1) >> s) - r0 + 1;
  const int rw = ((in_c0 + T::IN_W - 1) >> s) - c0 + 1;
  const int cells = rh * rw;
  const bool vec = copies16(G.x, G.cin);
  for (int i = threadIdx.x; i < 2 * cells; i += THREADS) {
    const int half = i >= cells;
    const int rc = i - half * cells;
    const int r = rc / rw, c = rc - r * rw;
    const int sr = r0 + r, sc = c0 + c;
    const bool inside = sr >= 0 && sr < src_h && sc >= 0 && sc < src_w;
    const int ch = ci0 + half * 8;
    uint16_t* dst = xs + ((half * T::IN_H + r) * T::IN_W + c) * 8;
    const uint16_t* src = G.x + ((size_t)(inside ? sr : 0) * src_w + (inside ? sc : 0)) * G.cin;
    if (vec) {
      const bool ok = inside && ch < G.cin;
      cp_async16(smem_addr(dst), ok ? src + ch : G.x, ok);
    } else {
      union {
        uint4 v;
        uint16_t h[8];
      } u;
#pragma unroll
      for (int j = 0; j < 8; ++j) u.h[j] = (inside && ch + j < G.cin) ? __ldg(src + ch + j) : 0;
      *reinterpret_cast<uint4*>(dst) = u.v;
    }
  }

  // Weights of the chunk: ws[tap][k][n] = k_g[tap][ci0 + k][n0 + n], zero
  // past Cin and past Cout.
  const bool wvec = P.cout % 8 == 0 && (reinterpret_cast<uintptr_t>(G.k) & 15) == 0;
  for (int i = threadIdx.x; i < 9 * CK * T::NT; i += THREADS) {
    const int row = i / T::NT, seg = i - row * T::NT;
    const int tap = row / CK, k = row - tap * CK;
    const int ci = ci0 + k, n = n0 + seg * 8;
    uint16_t* dst = ws + row * T::PITCH + seg * 8;
    const uint16_t* src = G.k + ((size_t)tap * G.cin + (ci < G.cin ? ci : 0)) * P.cout;
    if (wvec) {
      const bool ok = ci < G.cin && n < P.cout;
      cp_async16(smem_addr(dst), ok ? src + n : G.k, ok);
    } else {
      union {
        uint4 v;
        uint16_t h[8];
      } u;
#pragma unroll
      for (int j = 0; j < 8; ++j) u.h[j] = (ci < G.cin && n + j < P.cout) ? __ldg(src + n + j) : 0;
      *reinterpret_cast<uint4*>(dst) = u.v;
    }
  }
}

template <int NP, int S>
__device__ __forceinline__ void conv3x3_tile(const Params& P) {
  using T = Tile<NP, S>;
  constexpr int WM = T::WM, NT = T::NT;
  extern __shared__ __align__(16) uint16_t smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int in_r0 = blockIdx.y * T::TH * S - P.pad_top;
  const int in_c0 = blockIdx.x * TW * S - P.pad_left;
  const int n0 = blockIdx.z * NP;
  const int n_chunks = group_of(P, P.n_groups - 1).chunk_end;

  float acc[WM][NT][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // This thread's ldmatrix row of an A fragment: pixel px of the 16, the
  // first or second 8 channels of the chunk.  Of a B fragment: row k of the
  // chunk's 16, the first or second n8 fragment of the pair.
  const int px = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  const int b_k = lane & 15, b_pair = lane >> 4;
  const uint32_t smem0 = smem_addr(smem);

  load_chunk<NP, S>(P, 0, smem, smem + T::X_ELEMS, in_r0, in_c0, n0);
  cp_async_commit();
  int gi = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait_all();
    __syncthreads();  // chunk landed for all threads; chunk - 1's buffer is free
    if (chunk + 1 < n_chunks) {
      uint16_t* next = smem + ((chunk + 1) % STAGES) * T::STAGE_ELEMS;
      load_chunk<NP, S>(P, chunk + 1, next, next + T::X_ELEMS, in_r0, in_c0, n0);
    }
    cp_async_commit();

    while (chunk >= group_of(P, gi).chunk_end) ++gi;
    const int s = group_of(P, gi).shift;
    // Tap (dy, dx) of output pixel (row, px) reads staged cell
    // (((in_r0 + row * S + dy) >> s) - (in_r0 >> s), same for columns).
    int a_row[WM][3], a_col[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a_col[d] = ((in_c0 + px * S + d) >> s) - (in_c0 >> s);
#pragma unroll
      for (int i = 0; i < WM; ++i)
        a_row[i][d] = (a_half * T::IN_H + ((in_r0 + (warp * WM + i) * S + d) >> s) - (in_r0 >> s)) *
                      T::IN_W;
    }
    const uint32_t xs = smem0 + (chunk % STAGES) * T::STAGE_ELEMS * 2;
    const uint32_t ws = xs + T::X_ELEMS * 2 + (b_k * T::PITCH + b_pair * 8) * 2;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t a[WM][4];
#pragma unroll
        for (int i = 0; i < WM; ++i) ldmatrix_x4(a[i], xs + (a_row[i][dy] + a_col[dx]) * 16);
        const uint32_t wt = ws + (dy * 3 + dx) * CK * T::PITCH * 2;
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wt + j * 16);
#pragma unroll
          for (int i = 0; i < WM; ++i) {
            mma_bf16(acc[i][j], a[i], b[0], b[1]);
            mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
          }
        }
        if constexpr (NT % 2 == 1) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, wt + (NT - 1) * 16 - b_pair * 16);
#pragma unroll
          for (int i = 0; i < WM; ++i) mma_bf16(acc[i][NT - 1], a[i], b0, b1);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the stages: reuse them for the output

  // Epilogue: round the accumulator to bf16, add the bf16 bias (the sum of
  // two bf16 values in float32, rounded to bf16, is the bf16 add), ReLU;
  // into out_s[pixel][channel] of the tile.
  uint16_t* out_s = smem;
  const int q = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = j * 8 + c2;
    const float b0 = n0 + n < P.cout ? bf16_bits_to_float(__ldg(P.bias + n0 + n)) : 0.0f;
    const float b1 = n0 + n + 1 < P.cout ? bf16_bits_to_float(__ldg(P.bias + n0 + n + 1)) : 0.0f;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = round_to_bf16(round_to_bf16(acc[i][j][2 * h]) + b0);
        float v1 = round_to_bf16(round_to_bf16(acc[i][j][2 * h + 1]) + b1);
        if (P.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
        const int p = (warp * WM + i) * TW + q + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(out_s + p * T::PITCH + n) = y;
      }
    }
  }
  __syncthreads();

  // Write the tile: 16 contiguous bytes per thread where the layout allows.
  const int oy0 = blockIdx.y * T::TH, ox0 = blockIdx.x * TW;
  const int nc = min(NP, P.cout - n0);
  if (P.cout % 8 == 0 && (reinterpret_cast<uintptr_t>(P.out) & 15) == 0) {
    const int segs = nc / 8;
    for (int i = threadIdx.x; i < T::TH * TW * segs; i += THREADS) {
      const int p = i / segs, seg = i - p * segs;
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy < P.h_out && ox < P.w_out)
        *reinterpret_cast<uint4*>(P.out + ((size_t)oy * P.w_out + ox) * P.cout + n0 + seg * 8) =
            *reinterpret_cast<const uint4*>(out_s + p * T::PITCH + seg * 8);
    }
  } else {
    for (int i = threadIdx.x; i < T::TH * TW * nc; i += THREADS) {
      const int p = i / nc, n = i - p * nc;
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy < P.h_out && ox < P.w_out)
        P.out[((size_t)oy * P.w_out + ox) * P.cout + n0 + n] = out_s[p * T::PITCH + n];
    }
  }
}

template <int NP, int S>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(const Params P) {
  conv3x3_tile<NP, S>(P);
}

template <int NP, int S>
__global__ void __launch_bounds__(THREADS, 3) conv3x3_kernel_3blocks(const Params P) {
  conv3x3_tile<NP, S>(P);
}

using KernelFn = void (*)(const Params);

template <int NP, int S>
KernelFn kernel_of() {
  if constexpr (Tile<NP, S>::THREE_BLOCKS)
    return conv3x3_kernel_3blocks<NP, S>;
  else
    return conv3x3_kernel<NP, S>;
}

template <int NP, int S>
int launch(const Params& P, cudaStream_t stream) {
  using T = Tile<NP, S>;
  // Above 48 KB a block's dynamic shared memory must be allowed, once per
  // instantiation and device.
  static uint64_t allowed = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(allowed >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel_of<NP, S>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1ull << dev;
  }
  dim3 grid((P.w_out + TW - 1) / TW, (P.h_out + T::TH - 1) / T::TH, (P.cout + NP - 1) / NP);
  const KernelFn kernel = kernel_of<NP, S>();
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(P);
  return (int)cudaGetLastError();
}

template <int S>
int dispatch(const Params& P, cudaStream_t stream) {
  // N padded to the next of 8, 24, 32, 48, 96 output channels (3, 24, 28,
  // 48, 96 in the shipped networks); Cout > 96 in 96-channel slices.
  if (P.cout <= 8) return launch<8, S>(P, stream);
  if (P.cout <= 24) return launch<24, S>(P, stream);
  if (P.cout <= 32) return launch<32, S>(P, stream);
  if (P.cout <= 48) return launch<48, S>(P, stream);
  return launch<96, S>(P, stream);
}

// What the build made of one instantiation: NP, stride, tile rows, tile
// columns, registers per thread, dynamic shared bytes, static shared bytes,
// local (spilled) bytes per thread.
template <int NP, int S>
int info(int* out) {
  using T = Tile<NP, S>;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel_of<NP, S>());
  if (err != cudaSuccess) return (int)err;
  const int v[8] = {NP, S, T::TH, TW, a.numRegs, T::SMEM_BYTES, (int)a.sharedSizeBytes,
                    (int)a.localSizeBytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

using InfoFn = int (*)(int*);
constexpr InfoFn INSTANCES[] = {
    info<8, 1>, info<24, 1>, info<32, 1>, info<48, 1>, info<96, 1>,
    info<8, 2>, info<24, 2>, info<32, 2>, info<48, 2>, info<96, 2>,
};
constexpr int N_INSTANCES = sizeof(INSTANCES) / sizeof(INSTANCES[0]);

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
  int chunks = 0;
  for (int i = 0; i < MAX_GROUPS; ++i) {
    P.g[i].x = static_cast<const uint16_t*>(xs[i]);
    P.g[i].k = static_cast<const uint16_t*>(ks[i]);
    P.g[i].cin = cins[i];
    P.g[i].shift = ups[i] ? 1 : 0;
    if (i < n_groups) {
      if (xs[i] == nullptr || ks[i] == nullptr || cins[i] < 1) return (int)cudaErrorInvalidValue;
      chunks += (cins[i] + CK - 1) / CK;
    }
    P.g[i].chunk_end = chunks;
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

// Instantiation i of the kernel into out[8] (see info above); i < 0: the
// number of instantiations.
extern "C" int rtdc_conv3x3_info(int i, int* out) {
  if (i < 0) return N_INSTANCES;
  if (i >= N_INSTANCES || out == nullptr) return (int)cudaErrorInvalidValue;
  return INSTANCES[i](out);
}

extern "C" const char* rtdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
