// The per-pixel trace kernel of the PyTorch / CUDA port (sm_90a).
//
// Replaces: raytracingdiffusioncurves_tpu/ops/trace_pallas.py::_trace_kernel
// (the Pallas megakernel launched by trace_sums_flat).  It computes the same
// function: for every pixel of a row band, the fan of rays_per_pixel rays is
// generated (stratified sectors, AA jitter from the counter hash keyed on the
// global ray id), each ray finds its closest sub-segment hit (band-widened and
// strict winner chains, exact-silhouette root isolation for band-only
// winners), is shaded (side colour, blur, weight wm * t^-wd), follows portals
// for up to max_trace_depth + 1 traces, and the pixel's
// (sum c*w, sum w, sum blur*w) is written.  The math is the plain PyTorch
// version's (ops/intersect.py, ops/refine.py) expression for expression;
// built with --fmad=false, every multiply and add rounds alone as there.
//
// Design: one thread per pixel.  A CUDA block covers BLOCK pixels of
// one TILE_W-wide pixel tile, so every thread of a block shares the tile's
// per-wedge candidate lists and walks them in lockstep (the list entries are
// broadcast loads).  A thread loops over the wedges of its fan; a wedge whose
// list is empty contributes exactly zero and is skipped.  Portal
// continuation rays always walk every segment: lists cover primary rays only.
// The sums stay in registers and are written once per pixel, no atomics, so
// the output is deterministic.  The intersection constants and the shade
// table are staged in shared memory when they fit (72 floats per segment,
// s_pad <= 170), else read through the read-only cache and L2.
//
// Three walks of the primary rays, one kernel instantiation per family:
//  * id order (trace_kernel<false, false>): lists hold global segment ids in
//    ascending order and ties keep the first minimum, so a list walk finds
//    the same winner as the full sweep and the sums are bitwise the same;
//    without lists (any scene size) every segment is walked.
//  * distance order (trace_kernel<true, *>), dense scenes: a cell's list holds
//    its nearest cand_len segments sorted by a conservative lower-bound
//    distance lb (from any origin of the tile to any point of the
//    band-widened segment).  Slot k is tested only while lbs[k] is below the
//    ray's threshold: its strict chain's best key (a guaranteed crossing;
//    band keys are never larger), clamped by the distance at which the ray
//    leaves the scene's enclosing circle, with a 1e-5 slack because the
//    fast sincos directions are unit only to ~5e-7.  The tables' bounds are
//    bounds of the ordering key (ops/candidates.py, the key guard: a key is
//    the crossing with the chord's line, which for a ray nearly parallel to
//    a far chord lies anywhere), so the exit is exact.  When segments were
//    dropped (count > cand_len) and the threshold is still beyond the
//    horizon (the first dropped segment's lb) the ray continues into the
//    cell's sorted chunk list, chunk by chunk of 64 consecutive ids, under
//    the same rule.  Every segment left out has lb >= the threshold, so it
//    cannot win.  A walk in distance order meets ids in any order, and a
//    chunk may hold a segment the list already tested, so the winner is the
//    explicit (key, id) minimum: smaller key, then smaller id.
//  * chunk lists only (no segment lists): the chunk walk from an empty
//    state.
// The counting instantiation (trace_kernel<true, true>) also adds per-pixel
// counters of the walk; it is launched outside timed windows only.
//
// Dropped TPU workarounds: one-hot MXU gathers, bf16 hi/lo splits,
// transposed/128-lane layouts, the packed (t, id) sort key and the one-hot
// matmul reduction.  The winner ordering is the exact (t_est, id)
// lexicographic minimum of the plain version.
//
// Weight: w = wm * powf(t, -wd) for every scene, including the usual
// uniform wd = 0.5 where the Pallas kernel specializes to rsqrt: powf is what
// the plain version computes (torch.pow with a tensor exponent, the JAX
// oracle's jnp.power); 1/sqrtf would differ from it in the last ulp.
//
// Bound on this card: FP32 operations, not bytes.  Per primary ray of a
// non-empty cell, the list walk costs ~22-30 FP32 operations per candidate
// (three cross products, the strict and band acceptance tests, the ordering
// key), raygen ~38, Newton refinement + shading of a hit ~177 and root
// isolation of a graze ~448; with --fmad=false each is an instruction of its
// own, at half the FMA-counted FP32 peak.  The bytes are the lists (T*W*L
// int32), the tables (72 floats per segment) and 20 bytes of output per
// pixel, two orders of magnitude below the operation time.  What
// the design does about it: the per-cell lists cut the pairs walked from
// n_sub to the cell's count (mean ~7 of 128 on the main-path scene), empty
// cells skip the whole fan, and the walk reads its operands from shared
// memory.  Dense scenes do not fit shared memory; their per-ray exit cuts
// the pairs from the list length to the slots nearer than the ray's hit.
// chip_smoke.py computes the bound from the run's own counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define F32(x) ((float)(x))

// shade_all_t rows and seg_consts columns (scene/device.py).
constexpr int COL_CL0 = 4, COL_CL1 = 7, COL_CR0 = 10, COL_CR1 = 13;
constexpr int COL_BLUR0 = 16, COL_BLUR1 = 17, COL_WM0 = 18, COL_WM1 = 19;
constexpr int COL_WD0 = 20, COL_WD1 = 21, COL_PORTAL = 22;
constexpr int CONST_EX = 0, CONST_EY = 1, CONST_C1 = 2, CONST_P0X = 3,
              CONST_P0Y = 4, CONST_BAND = 6, CONST_QUAD = 7, CONST_COLS = 9;
constexpr int ALLT_SRC_CTRL = 37, ALLT_TGT_CTRL = 45, ALLT_T0 = 53,
              ALLT_DT = 54, ALLT_BAND = 55, ALLT_ROWS = 64;
constexpr int TILE_W = 16;
constexpr int STAGE_COLS = 8;  // seg_consts columns 0..7 staged
constexpr int SMEM_LIMIT = 48 * 1024;
constexpr int BLOCK = 128;  // threads (pixels of one tile) per CUDA block
constexpr int SEG_CHUNK = 64;  // segments per chunk of the chunk lists
// Per-pixel counters of the counting instantiation (trace_cuda.STAT_NAMES).
constexpr int STAT_RAYS = 0, STAT_SLOTS = 1, STAT_FALLBACK = 2, STAT_CHUNKS = 3,
              STAT_CHUNK_PAIRS = 4, STAT_CLEAN = 5, STAT_GRAZE = 6, N_STATS = 7;

// refine.py constants
constexpr int BISECT_ITERS = 5;

// rng.py constants
constexpr uint32_t M1 = 0x85EBCA6Bu, M2 = 0xC2B2AE35u, GOLDEN = 0x9E3779B9u,
                   H0 = 0x2F6E2B1u;

struct Params {
  const float* seg_consts;  // (s_pad, CONST_COLS)
  const float* shade;       // (ALLT_ROWS, s_pad)
  const int* cand_ids;      // (T, W, cand_len) or null
  const int* cand_counts;   // (T, W) or null
  const float* cand_lbs;    // (T, W, cand_len) or null: distance order
  const float* cand_horizon;  // (T, W) or null
  const int* chunk_ids;     // (T, W, chunk_slots) or null
  const float* chunk_lbs;   // (T, W, chunk_slots) or null
  const int* chunk_counts;  // (T, W) or null
  const float* circle;      // (4,) scene circle cx, cy, r; key slack (distance order)
  int* stats;               // (N_STATS, n_px) or null
  float* out;               // (5, n_px)
  int s_pad, n_sub, cand_len, chunk_slots, n_px;
  int width, height, px_start, tiles_x, tile_h, pxb, n_rows;
  int rpp, sw, n_wedges;
  float zoom, off_x, off_y;
  uint32_t frame, seed;
  int use_aa, save, exact, n_traces;
  float min_hit, sector;
  int staged;
};

// Scene tables, in shared or global memory: consts(j, c), shade(r, j).
struct Tables {
  const float* cst;
  int col_stride, row_stride;
  const float* shd;
  int s_pad;
  __device__ __forceinline__ float c(int j, int col) const {
    return cst[col * col_stride + j * row_stride];
  }
  __device__ __forceinline__ float s(int row, int j) const {
    return shd[row * s_pad + j];
  }
};

// ---------------------------------------------------------------- rng.py
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= M1;
  h ^= h >> 13;
  h *= M2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = H0;
  h = (h ^ fmix32(a + GOLDEN)) * M1 + GOLDEN;
  h = (h ^ fmix32(b + GOLDEN)) * M1 + GOLDEN;
  h = (h ^ fmix32(c + GOLDEN)) * M1 + GOLDEN;
  return fmix32(h);
}

// ----------------------------------------------------------- fastmath.py
__device__ __forceinline__ void fast_sincos(float x, float* sin_v, float* cos_v) {
  const float TWO_OVER_PI = F32(0.6366197723675814);
  const float PIO2_HI = F32(1.5707963705062866);
  const float PIO2_LO = F32(-4.371139000186241e-08);
  const float S1 = F32(-1.6666654611e-1), S2 = F32(8.3321608736e-3),
              S3 = F32(-1.9515295891e-4);
  const float C1 = F32(4.166664568298827e-2), C2 = F32(-1.388731625493765e-3),
              C3 = F32(2.443315711809948e-5);
  int q = (int)(x * TWO_OVER_PI + 0.5f);  // truncating, x >= 0
  float qf = (float)q;
  float d = (x - qf * PIO2_HI) - qf * PIO2_LO;
  float z = d * d;
  float s = ((S3 * z + S2) * z + S1) * z * d + d;
  float c = ((C3 * z + C2) * z + C1) * (z * z) - 0.5f * z + 1.0f;
  bool swap = (q & 1) == 1;
  float sv = swap ? c : s;
  float cv = swap ? s : c;
  *cos_v = (((q + 1) & 2) != 0) ? -cv : cv;
  *sin_v = ((q & 2) != 0) ? -sv : sv;
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ------------------------------------------------------------- refine.py
struct Bez {
  float bx, by, dbx, dby;
};

__device__ __forceinline__ Bez bezier_and_derivative(const float* cx, const float* cy, float tau) {
  float mt = 1.0f - tau;
  float b0 = mt * mt * mt;
  float b1 = 3.0f * mt * mt * tau;
  float b2 = 3.0f * mt * tau * tau;
  float b3 = tau * tau * tau;
  Bez r;
  r.bx = b0 * cx[0] + b1 * cx[1] + b2 * cx[2] + b3 * cx[3];
  r.by = b0 * cy[0] + b1 * cy[1] + b2 * cy[2] + b3 * cy[3];
  float d0 = 3.0f * mt * mt;
  float d1 = 6.0f * mt * tau;
  float d2 = 3.0f * tau * tau;
  r.dbx = d0 * (cx[1] - cx[0]) + d1 * (cx[2] - cx[1]) + d2 * (cx[3] - cx[2]);
  r.dby = d0 * (cy[1] - cy[0]) + d1 * (cy[2] - cy[1]) + d2 * (cy[3] - cy[2]);
  return r;
}

__device__ __forceinline__ void bezier_derivative_only(const float* cx, const float* cy, float tau,
                                                       float* dbx, float* dby) {
  float dx0 = 3.0f * (cx[1] - cx[0]);
  float dx1 = 6.0f * (cx[2] - 2.0f * cx[1] + cx[0]);
  float dx2 = 3.0f * (cx[3] - 3.0f * cx[2] + 3.0f * cx[1] - cx[0]);
  float dy0 = 3.0f * (cy[1] - cy[0]);
  float dy1 = 6.0f * (cy[2] - 2.0f * cy[1] + cy[0]);
  float dy2 = 3.0f * (cy[3] - 3.0f * cy[2] + 3.0f * cy[1] - cy[0]);
  *dbx = (dx2 * tau + dx1) * tau + dx0;
  *dby = (dy2 * tau + dy1) * tau + dy0;
}

// refine.refine_hit with NEWTON_ITERS = 1: returns tau, t_ref, dbx, dby.
__device__ void refine_hit(const float* cx, const float* cy, float tau0, float ox, float oy,
                           float dx, float dy, float t_chord, float min_hit, float* tau_out,
                           float* t_out, float* dbx, float* dby) {
  Bez b0 = bezier_and_derivative(cx, cy, tau0);
  Bez b = b0;
  float tau = tau0;
  {
    float f = dx * (b.by - oy) - dy * (b.bx - ox);
    float df = dx * b.dby - dy * b.dbx;
    float step = fabsf(df) > F32(1e-12) ? f / (df == 0.0f ? 1.0f : df) : 0.0f;
    tau = clamp01(tau - step);
    b = bezier_and_derivative(cx, cy, tau);
  }
  float f = dx * (b.by - oy) - dy * (b.bx - ox);
  float dd = dx * dx + dy * dy;
  float t_ref = ((b.bx - ox) * dx + (b.by - oy) * dy) / (dd == 0.0f ? 1.0f : dd);
  bool good = (t_ref >= min_hit) && (fabsf(f) < fabsf(t_chord) * F32(0.05) + 1.0f);
  *tau_out = good ? tau : tau0;
  *t_out = good ? t_ref : t_chord;
  *dbx = good ? b.dbx : b0.dbx;
  *dby = good ? b.dby : b0.dby;
}

struct Poly {
  float a0, a1, a2, a3;
  __device__ __forceinline__ float F(float t) const { return ((a3 * t + a2) * t + a1) * t + a0; }
  __device__ __forceinline__ float Fp(float t) const { return (3.0f * a3 * t + 2.0f * a2) * t + a1; }
};

__device__ __forceinline__ bool root_in(const Poly& P, float lo, float hi, float* tau_out) {
  float flo = P.F(lo);
  float fhi = P.F(hi);
  bool found = (flo * fhi <= 0.0f) && (hi > lo);
  float a = lo, b = hi, fa = flo;
#pragma unroll
  for (int i = 0; i < BISECT_ITERS; ++i) {
    float mid = 0.5f * (a + b);
    float fm = P.F(mid);
    bool left = fa * fm <= 0.0f;
    float na = left ? a : mid;
    float nb = left ? mid : b;
    fa = left ? fa : fm;
    a = na;
    b = nb;
  }
  float tau = 0.5f * (a + b);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float fp = P.Fp(tau);
    float step = P.F(tau) / (fp == 0.0f ? 1.0f : fp);
    tau = clampf(tau - (fabsf(fp) > F32(1e-30) ? step : 0.0f), a, b);
  }
  *tau_out = tau;
  return found;
}

// refine.refine_hit_exact: returns conv; tau, t_ref, dbx, dby.
__device__ bool refine_hit_exact(const float* cx, const float* cy, float tau0, float win0,
                                 float win_dt, float ox, float oy, float dx, float dy,
                                 float t_chord, float min_hit, float margin, float* tau_out,
                                 float* t_out, float* dbx, float* dby) {
  float b0_ = dx * (cy[0] - oy) - dy * (cx[0] - ox);
  float b1_ = dx * (cy[1] - oy) - dy * (cx[1] - ox);
  float b2_ = dx * (cy[2] - oy) - dy * (cx[2] - ox);
  float b3_ = dx * (cy[3] - oy) - dy * (cx[3] - ox);
  Poly P;
  P.a0 = b0_;
  P.a1 = 3.0f * (b1_ - b0_);
  P.a2 = 3.0f * (b2_ - 2.0f * b1_ + b0_);
  P.a3 = b3_ - 3.0f * b2_ + 3.0f * b1_ - b0_;
  float d0_ = dx * (cx[0] - ox) + dy * (cy[0] - oy);
  float d1_ = dx * (cx[1] - ox) + dy * (cy[1] - oy);
  float d2_ = dx * (cx[2] - ox) + dy * (cy[2] - oy);
  float d3_ = dx * (cx[3] - ox) + dy * (cy[3] - oy);
  float e0 = d0_;
  float e1 = 3.0f * (d1_ - d0_);
  float e2 = 3.0f * (d2_ - 2.0f * d1_ + d0_);
  float e3 = d3_ - 3.0f * d2_ + 3.0f * d1_ - d0_;
  float dd = dx * dx + dy * dy;
  float inv_dd = 1.0f / (dd == 0.0f ? 1.0f : dd);

  float qa = 3.0f * P.a3;
  float qb = 2.0f * P.a2;
  float qc = P.a1;
  float disc = qb * qb - 4.0f * qa * qc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float qq = -0.5f * (qb + (qb >= 0.0f ? sq : -sq));
  float rA = fabsf(qa) > F32(1e-30) ? qq / (qa == 0.0f ? 1.0f : qa) : -1.0f;
  float rB = fabsf(qq) > F32(1e-30) ? qc / (qq == 0.0f ? 1.0f : qq) : -1.0f;
  float lo_w = clamp01(win0 - margin);
  float hi_w = clamp01(win0 + win_dt + margin);
  bool bad = disc < 0.0f;
  rA = clampf(bad ? lo_w : rA, lo_w, hi_w);
  rB = clampf(bad ? lo_w : rB, lo_w, hi_w);
  float r1 = fminf(rA, rB);
  float r2 = fmaxf(rA, rB);

  const float INF = __int_as_float(0x7f800000);
  float best_t = INF, best_tau = tau0;
  float los[3] = {lo_w, r1, r2};
  float his[3] = {r1, r2, hi_w};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float tau_i;
    bool found = root_in(P, los[k], his[k], &tau_i);
    float t_i = (((e3 * tau_i + e2) * tau_i + e1) * tau_i + e0) * inv_dd;
    bool ok = found && (t_i >= min_hit) && (t_i < best_t);
    best_t = ok ? t_i : best_t;
    best_tau = ok ? tau_i : best_tau;
  }
  bool conv = best_t < INF;  // a root was accepted
  float tau = conv ? best_tau : tau0;
  *tau_out = tau;
  *t_out = conv ? best_t : t_chord;
  bezier_derivative_only(cx, cy, tau, dbx, dby);
  return conv;
}

// --------------------------------------------------------- intersect.py
struct Shaded {
  bool hit, portal;
  float t, r, g, b, blur, wm, wd;
  float eox, eoy, edx, edy;
};

// Chord intersection of ray (o, d) with sub-segment j: denom, num_t, num_s
// exactly as intersect_consts (cross = oy*dx - ox*dy, hoisted per ray).
struct Pair {
  float denom, num_t, num_s;
};

__device__ __forceinline__ Pair pair_at(const Tables& T, int j, float ox, float oy, float dx,
                                        float dy, float cross) {
  float ex = T.c(j, CONST_EX), ey = T.c(j, CONST_EY);
  Pair p;
  p.denom = dx * ey - dy * ex;
  p.num_t = T.c(j, CONST_C1) - ox * ey + oy * ex;
  p.num_s = dy * T.c(j, CONST_P0X) - dx * T.c(j, CONST_P0Y) + cross;
  return p;
}

// shade() of ops/intersect.py for one ray and winner j.
__device__ Shaded shade(const Tables& T, const Params& P, int j, float ox, float oy, float dx,
                        float dy, float cross, bool exact_refine, bool need_exit) {
  Pair pr = pair_at(T, j, ox, oy, dx, dy, cross);
  float inv = pr.denom == 0.0f ? 0.0f : 1.0f / pr.denom;
  float t_chord = pr.num_t * inv;
  float s = clamp01(pr.num_s * inv);

  float t0 = T.s(ALLT_T0, j), dt = T.s(ALLT_DT, j);
  float cx[4], cy[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cx[i] = T.s(ALLT_SRC_CTRL + 2 * i, j);
    cy[i] = T.s(ALLT_SRC_CTRL + 2 * i + 1, j);
  }
  float tau, t_ref, dbx, dby;
  bool hit = true;
  if (exact_refine) {
    float gex = T.c(j, CONST_EX), gey = T.c(j, CONST_EY);
    float band = T.s(ALLT_BAND, j);
    float chord = sqrtf(gex * gex + gey * gey);
    float margin = clamp01(F32(0.25) * band * dt / fmaxf(chord, F32(1e-9)));
    bool conv = refine_hit_exact(cx, cy, t0 + s * dt, t0, dt, ox, oy, dx, dy, t_chord,
                                 P.min_hit, margin, &tau, &t_ref, &dbx, &dby);
    bool strict = (pr.num_s * (pr.denom - pr.num_s) >= 0.0f) &&
                  ((pr.num_t - P.min_hit * pr.denom) * pr.denom > 0.0f);
    hit = conv || strict;
  } else {
    refine_hit(cx, cy, t0 + s * dt, ox, oy, dx, dy, t_chord, P.min_hit, &tau, &t_ref, &dbx,
               &dby);
  }
  Shaded h;
  h.hit = hit;
  if (!hit) return h;
  h.t = t_ref;
  float sf = clamp01((tau - t0) / (dt == 0.0f ? 1.0f : dt));
  float nx = dby, ny = -dbx;
  float ndotd = nx * dx + ny * dy;
  bool is_right = (ndotd <= 0.0f) != (P.save != 0);
  int c0 = is_right ? COL_CR0 : COL_CL0;
  int c1 = is_right ? COL_CR1 : COL_CL1;
  float a;
  a = T.s(c0, j);
  h.r = a + (T.s(c1, j) - a) * sf;
  a = T.s(c0 + 1, j);
  h.g = a + (T.s(c1 + 1, j) - a) * sf;
  a = T.s(c0 + 2, j);
  h.b = a + (T.s(c1 + 2, j) - a) * sf;
  a = T.s(COL_BLUR0, j);
  h.blur = a + (T.s(COL_BLUR1, j) - a) * sf;
  a = T.s(COL_WM0, j);
  h.wm = a + (T.s(COL_WM1, j) - a) * sf;
  a = T.s(COL_WD0, j);
  h.wd = a + (T.s(COL_WD1, j) - a) * sf;
  h.portal = need_exit && T.s(COL_PORTAL, j) > 0.0f;
  if (h.portal) {
    // Portal exit (DeviceCode.cu:227-257), the reference's sin = nx*dy + ny*dx
    // and unnormalized rotated direction reproduced verbatim.
    float nlen = fmaxf(sqrtf(nx * nx + ny * ny), F32(1e-30));
    float nxu = nx / nlen, nyu = ny / nlen;
    float ray_cos = nxu * dx + nyu * dy;
    float ray_sin = nxu * dy + nyu * dx;
    float tcx[4], tcy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tcx[i] = T.s(ALLT_TGT_CTRL + 2 * i, j);
      tcy[i] = T.s(ALLT_TGT_CTRL + 2 * i + 1, j);
    }
    Bez e = bezier_and_derivative(tcx, tcy, tau);
    float tnx = e.dby, tny = -e.dbx;
    float tlen = fmaxf(sqrtf(tnx * tnx + tny * tny), F32(1e-30));
    tnx = tnx / tlen;
    tny = tny / tlen;
    h.edx = tnx * ray_cos - tny * ray_sin;
    h.edy = tny * ray_cos + tnx * ray_sin;
    h.eox = e.bx;
    h.eoy = e.by;
  }
  return h;
}

// Running (key, id) minima of both chains.
struct Best {
  float kb, ks;
  int wb, ws;
};

// One (ray, segment) test of closest_hit, for both chains.  A walk in
// ascending id order keeps the first minimum (TIE false); a walk in
// distance order takes the explicit tie-break, smaller key, then smaller
// id (TIE true), so the order in which segments are met, and meeting one
// twice, cannot change the winner.
template <bool EXACT, bool TIE>
__device__ __forceinline__ void consider(const Tables& T, int j, float ox, float oy, float dx,
                                         float dy, float cross, float band_scale, float min_hit,
                                         Best& b) {
  Pair p = pair_at(T, j, ox, oy, dx, dy, cross);
  float prod_s = p.num_s * (p.denom - p.num_s);
  float tcut = (p.num_t - min_hit * p.denom) * p.denom;
  bool sv = (prod_s >= 0.0f) && (tcut > 0.0f);
  bool bv = false;
  if (EXACT) {
    float h = T.c(j, CONST_BAND) * band_scale;
    float had = h * fabsf(p.denom);
    bv = (prod_s + had + h * h >= 0.0f) && (tcut + had > 0.0f);
  }
  if (sv || bv) {
    float inv = p.denom == 0.0f ? 0.0f : 1.0f / p.denom;
    float s = p.num_s * inv;
    float t_est = (p.num_t - T.c(j, CONST_QUAD) * s * (1.0f - s)) * inv;
    float key = fmaxf(t_est, F32(1e-30));
    if (EXACT && bv && (key < b.kb || (TIE && key == b.kb && j < b.wb))) {
      b.kb = key;
      b.wb = j;
    }
    if (sv && (key < b.ks || (TIE && key == b.ks && j < b.ws))) {
      b.ks = key;
      b.ws = j;
    }
  }
}

// closest_hit for both chains over a list (ids) or every segment (ids null):
// the exact (key, id) minimum, first minimum on ties, ids ascending.
template <bool EXACT>
__device__ __forceinline__ void walk(const Tables& T, const int* ids, int n, float ox, float oy,
                                     float dx, float dy, float cross, float band_scale,
                                     float min_hit, int* best_b, int* best_s) {
  const float INF = __int_as_float(0x7f800000);
  Best b = {INF, INF, -1, -1};
  for (int k = 0; k < n; ++k)
    consider<EXACT, false>(T, ids ? __ldg(ids + k) : k, ox, oy, dx, dy, cross, band_scale,
                           min_hit, b);
  *best_b = b.wb;
  *best_s = b.ws;
}

// The per-ray clean rule on the two chains' winners (wb band, ws strict;
// without exact silhouettes only ws is set).
__device__ Shaded resolve(const Tables& T, const Params& P, int wb, int ws, float ox, float oy,
                          float dx, float dy, float cross, bool need_exit) {
  if (!P.exact) {
    if (ws < 0) {
      Shaded miss;
      miss.hit = false;
      return miss;
    }
    return shade(T, P, ws, ox, oy, dx, dy, cross, false, need_exit);
  }
  if (wb < 0) {
    Shaded miss;
    miss.hit = false;
    return miss;
  }
  if (ws >= 0 && wb == ws) return shade(T, P, ws, ox, oy, dx, dy, cross, false, need_exit);
  Shaded hb = shade(T, P, wb, ox, oy, dx, dy, cross, true, need_exit);
  if (!hb.hit && ws >= 0) return shade(T, P, ws, ox, oy, dx, dy, cross, false, need_exit);
  return hb;
}

// trace_and_shade: the two winner chains over a list or every segment, in
// id order, and the clean rule.
__device__ Shaded trace_and_shade(const Tables& T, const Params& P, const int* ids, int n,
                                  float ox, float oy, float dx, float dy, bool need_exit) {
  float cross = oy * dx - ox * dy;
  int wb = -1, ws = -1;
  if (!P.exact) {
    walk<false>(T, ids, n, ox, oy, dx, dy, cross, 0.0f, P.min_hit, &wb, &ws);
  } else {
    float band_scale = sqrtf(dx * dx + dy * dy);
    walk<true>(T, ids, n, ox, oy, dx, dy, cross, band_scale, P.min_hit, &wb, &ws);
  }
  return resolve(T, P, wb, ws, ox, oy, dx, dy, cross, need_exit);
}

// ------------------------------------------------- distance-ordered walks
// Distance beyond which nothing can beat the ray's strict best: the best
// key or the scene exit, whichever is nearer, with the unit-direction slack.
__device__ __forceinline__ float walk_threshold(const Best& b, float texit) {
  return fminf(b.ks, texit) * F32(1.00001);
}

// Primary ray through a cell's distance-ordered tables: the capped list
// while its lower bounds stay below the threshold, then, if segments were
// dropped and the horizon is still below it (or there is no list), the
// sorted chunk list under the same rule.  ``st``: this thread's counters.
template <bool EXACT, bool STATS>
__device__ __forceinline__ void walk_dist(const Tables& T, const Params& P, int cell, float ox,
                                          float oy, float dx, float dy, float cross,
                                          float band_scale, int* best_b, int* best_s, int* st) {
  const float INF = __int_as_float(0x7f800000);
  Best b = {INF, INF, -1, -1};
  // Where the ray leaves the scene's enclosing circle: no hit lies beyond
  // (every band-widened sub-segment is inside, the circle is convex), and
  // no key lies further beyond than the largest key slack.  A ray that
  // never enters, or leaves behind its origin, exits at 0.
  const float pcx = __ldg(P.circle) - ox, pcy = __ldg(P.circle + 1) - oy;
  const float cr = __ldg(P.circle + 2);
  const float bq = dx * pcx + dy * pcy;
  const float disc = bq * bq - (pcx * pcx + pcy * pcy - cr * cr);
  const float texit =
      fmaxf(disc >= 0.0f ? bq + sqrtf(fmaxf(disc, 0.0f)) : 0.0f, 0.0f) * F32(1.00002) +
      __ldg(P.circle + 3);

  bool into_chunks = true;
  if (P.cand_ids) {
    const int count = __ldg(P.cand_counts + cell);
    const int n = min(count, P.cand_len);
    const int* ids = P.cand_ids + (size_t)cell * P.cand_len;
    const float* lbs = P.cand_lbs + (size_t)cell * P.cand_len;
    int k = 0;
    for (; k < n; ++k) {
      if (!(__ldg(lbs + k) < walk_threshold(b, texit))) break;
      consider<EXACT, true>(T, __ldg(ids + k), ox, oy, dx, dy, cross, band_scale, P.min_hit, b);
    }
    if (STATS) st[STAT_SLOTS] += k;
    into_chunks = P.chunk_ids && count > P.cand_len &&
                  __ldg(P.cand_horizon + cell) < walk_threshold(b, texit);
  }
  if (into_chunks) {
    const int n = __ldg(P.chunk_counts + cell);
    const int* cids = P.chunk_ids + (size_t)cell * P.chunk_slots;
    const float* clbs = P.chunk_lbs + (size_t)cell * P.chunk_slots;
    int c = 0;
    for (; c < n; ++c) {
      if (!(__ldg(clbs + c) < walk_threshold(b, texit))) break;
      const int j0 = __ldg(cids + c) * SEG_CHUNK;
      const int j1 = min(j0 + SEG_CHUNK, P.n_sub);
      for (int j = j0; j < j1; ++j)
        consider<EXACT, true>(T, j, ox, oy, dx, dy, cross, band_scale, P.min_hit, b);
      if (STATS) st[STAT_CHUNK_PAIRS] += max(j1 - j0, 0);
    }
    if (STATS) {
      st[STAT_CHUNKS] += c;
      st[STAT_FALLBACK] += c > 0;
    }
  }
  *best_b = b.wb;
  *best_s = b.ws;
}

template <bool DIST, bool STATS>
__global__ void __launch_bounds__(BLOCK) trace_kernel(const Params P) {
  extern __shared__ float smem[];
  Tables T;
  if (P.staged) {
    const int ns = STAGE_COLS * P.s_pad;
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      int col = i / P.s_pad, j = i - col * P.s_pad;
      smem[i] = P.seg_consts[j * CONST_COLS + col];
    }
    for (int i = threadIdx.x; i < ALLT_ROWS * P.s_pad; i += blockDim.x)
      smem[ns + i] = P.shade[i];
    __syncthreads();
    T = Tables{smem, P.s_pad, 1, smem + ns, P.s_pad};
  } else {
    T = Tables{P.seg_consts, 1, CONST_COLS, P.shade, P.s_pad};
  }

  const int tile = blockIdx.x;
  const int pin = blockIdx.y * blockDim.x + threadIdx.x;  // pixel within tile
  if (pin >= P.pxb) return;
  const int tile_r = tile / P.tiles_x;
  const int tile_c = tile - tile_r * P.tiles_x;
  const int col = tile_c * TILE_W + (pin & (TILE_W - 1));
  const int row_rel = tile_r * P.tile_h + pin / TILE_W;
  if (col >= P.width || row_rel >= P.n_rows) return;
  const int row = P.px_start / P.width + row_rel;
  const uint32_t pixel = (uint32_t)row * (uint32_t)P.width + (uint32_t)col;

  const float ox0 = (float)(col - P.width / 2) * P.zoom + P.off_x;
  const float oy0 = P.save ? (float)((P.height - row) - P.height / 2) * P.zoom + P.off_y
                           : (float)(row - P.height / 2) * P.zoom + P.off_y;
  const bool need_exit = P.n_traces > 1;

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f, acc4 = 0.0f;
  int st[N_STATS] = {0, 0, 0, 0, 0, 0, 0};
  for (int w = 0; w < P.n_wedges; ++w) {
    const int* ids = nullptr;
    int n0 = P.n_sub;
    const int cell = tile * P.n_wedges + w;
    if (DIST) {
      // empty cell: no segment (or chunk) passes, every primary ray misses
      if (__ldg((P.cand_ids ? P.cand_counts : P.chunk_counts) + cell) == 0) continue;
    } else if (P.cand_ids) {
      n0 = min(__ldg(P.cand_counts + cell), P.cand_len);
      if (n0 == 0) continue;  // empty cell: every primary ray misses
      ids = P.cand_ids + (size_t)cell * P.cand_len;
    }
    for (int k = 0; k < P.sw; ++k) {
      const int sample = w * P.sw + k;
      // --- raygen (intersect.make_rays) ---
      float ox = ox0, oy = oy0, dx, dy, theta;
      if (P.use_aa) {
        uint32_t bits = hash3(P.seed, pixel * (uint32_t)P.rpp + (uint32_t)sample, P.frame);
        float u_rot = (float)(int)(bits >> 21) * (1.0f / 2048.0f);
        float u_x = (float)(int)((bits >> 10) & 0x7FFu) * (1.0f / 2048.0f);
        float u_y = (float)(int)(bits & 0x3FFu) * (1.0f / 1024.0f);
        theta = P.sector * ((float)sample + u_rot);
        ox = ox0 + u_x * P.zoom;
        oy = oy0 + u_y * P.zoom;
      } else {
        theta = P.sector * ((float)sample + 0.0f);
      }
      fast_sincos(theta, &dy, &dx);

      // --- trace with portal continuation (intersect.trace_full) ---
      float fr = 1.0f, fg = 1.0f, fb = 1.0f, inv_w = 0.0f, blur_prod = 1.0f;
      for (int bounce = 0; bounce < P.n_traces; ++bounce) {
        Shaded h;
        if (DIST && bounce == 0) {
          const float cross = oy * dx - ox * dy;
          int wb = -1, ws = -1;
          if (P.exact) {
            walk_dist<true, STATS>(T, P, cell, ox, oy, dx, dy, cross,
                                   sqrtf(dx * dx + dy * dy), &wb, &ws, st);
          } else {
            walk_dist<false, STATS>(T, P, cell, ox, oy, dx, dy, cross, 0.0f, &wb, &ws, st);
          }
          if (STATS) {
            st[STAT_RAYS] += 1;
            const bool graze = P.exact && wb >= 0 && wb != ws;
            st[STAT_GRAZE] += graze;
            st[STAT_CLEAN] += !graze && ws >= 0;
          }
          h = resolve(T, P, wb, ws, ox, oy, dx, dy, cross, need_exit);
        } else {
          const int* L = bounce == 0 ? ids : nullptr;
          const int n = bounce == 0 ? n0 : P.n_sub;
          h = trace_and_shade(T, P, L, n, ox, oy, dx, dy, need_exit);
        }
        if (!h.hit) break;
        float w_self = h.wm * powf(h.t, -h.wd);
        if (!h.portal) {
          float w_final = 1.0f / (inv_w + 1.0f / w_self);
          acc0 += (fr * h.r) * w_final;
          acc1 += (fg * h.g) * w_final;
          acc2 += (fb * h.b) * w_final;
          acc3 += w_final;
          acc4 += (blur_prod * h.blur) * w_final;
          break;
        }
        fr = fr * h.r;
        fg = fg * h.g;
        fb = fb * h.b;
        inv_w = inv_w + 1.0f / w_self;
        blur_prod = blur_prod * h.blur;
        ox = h.eox;
        oy = h.eoy;
        dx = h.edx;
        dy = h.edy;
      }
    }
  }
  const int p = row_rel * P.width + col;
  P.out[p] = acc0;
  P.out[P.n_px + p] = acc1;
  P.out[2 * P.n_px + p] = acc2;
  P.out[3 * P.n_px + p] = acc3;
  P.out[4 * P.n_px + p] = acc4;
  if (STATS) {
#pragma unroll
    for (int i = 0; i < N_STATS; ++i) P.stats[i * P.n_px + p] += st[i];
  }
}

}  // namespace

// Tables (trace_cuda.CandTables): id-ordered lists are cand_ids + cand_counts
// alone; distance-ordered tables add cand_lbs + cand_horizon and/or the chunk
// lists, with the scene circle.  ``stats`` (distance order only) selects the
// counting instantiation.
extern "C" int rtdc_trace_sums(const float* seg_consts, const float* shade_all_t, int s_pad,
                               int n_sub, const int* cand_ids, const int* cand_counts,
                               int cand_len, const float* cand_lbs, const float* cand_horizon,
                               const int* chunk_ids, const float* chunk_lbs,
                               const int* chunk_counts, int chunk_slots, const float* circle,
                               int* stats, float* out, int n_px, int width, int height,
                               int px_start, int tiles_x, int tiles_y, int tile_h, int pxb,
                               int rpp, int sw, int n_wedges, float zoom, float off_x,
                               float off_y, uint32_t frame, uint32_t seed, int use_aa, int save,
                               int exact, int n_traces, float min_hit, void* stream) {
  if (width <= 0 || rpp <= 0 || sw <= 0 || pxb <= 0) return (int)cudaErrorInvalidValue;
  const bool dist = cand_lbs != nullptr || chunk_ids != nullptr;
  if (dist) {
    if (!circle) return (int)cudaErrorInvalidValue;
    if (cand_ids && !(cand_counts && cand_lbs && cand_horizon)) return (int)cudaErrorInvalidValue;
    if (chunk_ids && !(chunk_lbs && chunk_counts)) return (int)cudaErrorInvalidValue;
  } else if (stats || (cand_ids && !cand_counts)) {
    return (int)cudaErrorInvalidValue;
  }
  Params P;
  P.seg_consts = seg_consts;
  P.shade = shade_all_t;
  P.cand_ids = cand_ids;
  P.cand_counts = cand_counts;
  P.cand_lbs = cand_lbs;
  P.cand_horizon = cand_horizon;
  P.chunk_ids = chunk_ids;
  P.chunk_lbs = chunk_lbs;
  P.chunk_counts = chunk_counts;
  P.chunk_slots = chunk_slots;
  P.circle = circle;
  P.stats = stats;
  P.out = out;
  P.s_pad = s_pad;
  P.n_sub = n_sub;
  P.cand_len = cand_len;
  P.n_px = n_px;
  P.width = width;
  P.height = height;
  P.px_start = px_start;
  P.tiles_x = tiles_x;
  P.tile_h = tile_h;
  P.pxb = pxb;
  P.n_rows = n_px / width;
  P.rpp = rpp;
  P.sw = sw;
  P.n_wedges = n_wedges;
  P.zoom = zoom;
  P.off_x = off_x;
  P.off_y = off_y;
  P.frame = frame;
  P.seed = seed;
  P.use_aa = use_aa;
  P.save = save;
  P.exact = exact;
  P.n_traces = n_traces;
  P.min_hit = min_hit;
  // 2*pi/rpp in float32, as raygen computes it (float(2*pi) / float(rpp)).
  P.sector = F32(6.283185307179586) / (float)rpp;
  size_t smem = (size_t)(STAGE_COLS + ALLT_ROWS) * s_pad * sizeof(float);
  P.staged = smem <= SMEM_LIMIT;
  if (!P.staged) smem = 0;
  dim3 grid(tiles_x * tiles_y, (pxb + BLOCK - 1) / BLOCK);
  if (!dist) {
    trace_kernel<false, false><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(P);
  } else if (!stats) {
    trace_kernel<true, false><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(P);
  } else {
    trace_kernel<true, true><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(P);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rtdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
