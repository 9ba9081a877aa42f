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
// one TILE_W-wide pixel tile, so the 32 lanes of a warp trace rays of the
// same (tile, wedge) cell at the same time and walk the same list.  A thread
// loops over the wedges of its fan; a wedge whose list is empty contributes
// exactly zero and is skipped.  Portal continuation rays always walk every
// segment: lists cover primary rays only.  Each thread adds its pixel's
// sums in its own shared-memory slots and writes them once, no atomics, so
// the output is deterministic.  Wedge-coarsened tables (past 64 wedges, or
// past the tables' byte cap: trace_cuda.table_layout) share one entry among
// 2^shift adjacent wedges; a wedge reads its entry at w >> shift, while
// raygen and the wedge loop keep the fine wedge.
//
// Operands.  Every walk (a cell's list, the sorted chunk walk, the full
// sweep, portal bounces) is cut into pieces of 32 slots.  The warp stages a
// piece in its own shared memory: lane l loads slot l's segment id (and, in
// distance order, its lower bound) and copies that segment's 32-byte walk
// record (scene/device.py::walk_records: ex, ey, c1, p0x, p0y, band, quad,
// id) with two 16-byte cp.async.  The next piece is in flight while the warp
// walks the current one; the per-slot loop reads a record with two broadcast
// 16-byte shared loads (and one for the bound), with no global load and no
// dependent chain.  Staging is warp-local (cp.async.wait_all, __syncwarp),
// never a block barrier, so lanes of one warp stay in lockstep where they
// must (staging, votes) and diverge where the walk does (per-ray exits).  A
// winner is shaded from its 256-byte shade record (the column of
// shade_all_t, scene/device.py::shade_records) with 16-byte loads through
// L1.  Every scene size takes this one data path.  (Keeping a cell's first
// pieces staged for the sw samples of its wedge did not pay: the pieces
// hit L1, and the larger footprint cost L1 and occupancy; PERF.md.)
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
//    explicit (key, id) minimum: smaller key, then smaller id.  The warp
//    fetches a further piece while any lane still walks.
//  * chunk lists only (no segment lists): the chunk walk from an empty
//    state.
// The counting instantiation (trace_kernel<true, true>) also adds per-pixel
// counters of the walk and of the portal bounces' sweeps; it is launched
// outside timed windows only.
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
// int32), the records (96 floats per segment) and 20 bytes of output per
// pixel, two orders of magnitude below the operation time.  What holds the
// kernel below that bound is issue slots spent on anything but those
// operations: loads (loads and FP32 share the SM's four warp instructions a
// clock), waits on dependent loads, lanes idle while the slowest lane of
// their warp walks on (counted by the warp_slots counter), and occupancy
// (registers).  What the design does about it: the per-cell lists cut the
// pairs walked from n_sub to the cell's count, empty cells skip the whole
// fan, the distance-ordered walk's per-ray exit cuts a dense list to the
// slots nearer than the ray's hit, a pair costs two shared loads and no
// global one, and its exit test one compare (the threshold is
// recomputed only when the strict best moves), the staging of the next
// piece overlaps the walk of the current one, and no block stages whole
// tables, so registers alone set residency.  Registers: the pixel's
// sums and a ray's portal chain live in shared memory and a walk's list is
// an offset, so the launch bounds hold 8 blocks (id order) or 7 (distance
// order) of 128 threads per SM, 64 or 72 registers, with ptxas's spills in
// shading and none in the walks.  chip_smoke.py computes the bound from the
// run's own counts and prints registers and blocks per SM
// ([trace_kernel:*], from rtdc_trace_info).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define F32(x) ((float)(x))

// Rows of shade_all_t (= columns of a shade record, scene/device.py).
constexpr int ALLT_ROWS = 64;
constexpr int TILE_W = 16;
constexpr int BLOCK = 128;  // threads (pixels of one tile) per CUDA block
// Blocks per SM the registers must allow, per instantiation (measured:
// PERF.md; ptxas keeps the walk loops in registers and spills in shading).
constexpr int MIN_BLOCKS_ID = 8;
constexpr int MIN_BLOCKS_DIST = 7;
constexpr int WARP = 32;
constexpr int WARPS = BLOCK / WARP;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NBUF = 2;  // piece buffers per warp, taking turns
constexpr int SEG_CHUNK = 64;  // segments per chunk of the chunk lists
// Per-pixel counters of the counting instantiation (trace_cuda.STAT_NAMES).
constexpr int STAT_RAYS = 0, STAT_SLOTS = 1, STAT_FALLBACK = 2, STAT_CHUNKS = 3,
              STAT_CHUNK_PAIRS = 4, STAT_CLEAN = 5, STAT_GRAZE = 6, STAT_WARP_SLOTS = 7,
              STAT_BOUNCE_RAYS = 8, STAT_SWEEP_SLOTS = 9, STAT_SWEEP_WARP_SLOTS = 10,
              N_STATS = 11;

// refine.py constants
constexpr int BISECT_ITERS = 5;

// rng.py constants
constexpr uint32_t M1 = 0x85EBCA6Bu, M2 = 0xC2B2AE35u, GOLDEN = 0x9E3779B9u,
                   H0 = 0x2F6E2B1u;

struct Params {
  const float4* walk;       // (s_pad, 8): two float4 walk records per segment
  const float4* shade;      // (s_pad, ALLT_ROWS): sixteen float4 per segment
  // Tables per (tile, table wedge) cell: W_t = n_wedges >> wedge_shift
  // table wedges, each entry shared by 2^wedge_shift adjacent wedges.
  const int* cand_ids;      // (T, W_t, cand_len) or null
  const int* cand_counts;   // (T, W_t) or null
  const float* cand_lbs;    // (T, W_t, cand_len) or null: distance order
  const float* cand_horizon;  // (T, W_t) or null
  const int* chunk_ids;     // (T, W_t, chunk_slots) or null
  const float* chunk_lbs;   // (T, W_t, chunk_slots) or null
  const int* chunk_counts;  // (T, W_t) or null
  const float* circle;      // (4,) scene circle cx, cy, r; key slack (distance order)
  int* stats;               // (N_STATS, n_px) or null
  float* out;               // (5, n_px)
  int n_sub, cand_len, chunk_slots, n_px;
  int width, height, px_start, tiles_x, tile_h, pxb, n_rows;
  int rpp, sw, n_wedges, tab_wedges, wedge_shift;
  float zoom, off_x, off_y;
  uint32_t frame, seed;
  int use_aa, save, exact, n_traces;
  float min_hit, sector;
};

// One sub-segment's walk record: the seg_consts columns consider() reads.
struct Rec {
  float ex, ey, c1, p0x, p0y, band, quad;
  int id;
};

__device__ __forceinline__ Rec unpack(float4 a, float4 b) {
  return Rec{a.x, a.y, a.z, a.w, b.x, b.y, b.z, __float_as_int(b.w)};
}

// -------------------------------------------------------------- staging
// A piece: the walk records of 32 consecutive slots of a walk and, in
// distance order, their lower bounds, in one warp's shared memory.
struct Piece {
  float4 rec[WARP][2];
  float lb[WARP];
};

// The n slots of one walk: with list >= 0, slot s holds segment
// cand_ids[list + s] (with its bound cand_lbs[list + s] where the tables
// have bounds); else segment base + s.  Offsets, not pointers: fewer
// registers live through the walk.
struct Span {
  int list, base, n;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This lane's copies landed; with __syncwarp after it, every lane's.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of piece q of the walk into buffer q % NBUF of the warp's
// ``buf``: lane l fetches slot 32 q + l.
__device__ __forceinline__ void stage(const Params& P, Piece* buf, const Span& sp, int q,
                                      int lane) {
  Piece* b = buf + q % NBUF;
  const int s = q * WARP + lane;
  if (s < sp.n) {
    const int j = sp.list >= 0 ? __ldg(P.cand_ids + sp.list + s) : sp.base + s;
    const float4* src = P.walk + 2 * (size_t)j;
    cp_async16(&b->rec[lane][0], src);
    cp_async16(&b->rec[lane][1], src + 1);
    if (sp.list >= 0 && P.cand_lbs) cp_async4(&b->lb[lane], P.cand_lbs + sp.list + s);
  }
  cp_async_commit();
}

// Piece p of the walk, landed for every lane; piece p + 1 set in flight.
// Called by all lanes of the warp at once (warp-uniform p); the buffer of
// p + 1 is free because every lane has passed this __syncwarp after walking
// p - 1.
__device__ __forceinline__ const Piece* acquire(const Params& P, Piece* buf, const Span& sp,
                                                int p, int n_pieces, int lane) {
  if (p == 0) stage(P, buf, sp, 0, lane);
  cp_async_wait_all();
  __syncwarp();
  if (p + 1 < n_pieces) stage(P, buf, sp, p + 1, lane);
  return buf + p % NBUF;
}

// End of a walk: nothing in flight, every lane done reading its buffers.
__device__ __forceinline__ void release() {
  cp_async_wait_all();
  __syncwarp();
}

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

// One ray: origin, direction, the hoisted cross term oy*dx - ox*dy and the
// band scale |d| (0 without exact silhouettes).
struct Ray {
  float ox, oy, dx, dy, cross, band_scale;
};

// Chord intersection of ray (o, d) with a sub-segment: denom, num_t, num_s
// exactly as intersect_consts.
struct Pair {
  float denom, num_t, num_s;
};

__device__ __forceinline__ Pair pair_at(const Rec& g, const Ray& r) {
  Pair p;
  p.denom = r.dx * g.ey - r.dy * g.ex;
  p.num_t = g.c1 - r.ox * g.ey + r.oy * g.ex;
  p.num_s = r.dy * g.p0x - r.dx * g.p0y + r.cross;
  return p;
}

// shade() of ops/intersect.py for one ray and winner j.  The winner's shade
// record is its column of shade_all_t: float4 k holds rows 4k..4k+3 (rows
// 4-15 the left and right colours at both ends, 16-22 blur, weight, weight
// degree at both ends and the portal flag, 37-44 the source control points
// x0, y0 .. x3, y3, 45-52 the portal target's, 53-55 t0, dt, band).
__device__ Shaded shade(const Params& P, int j, const Ray& ray, bool exact_refine,
                        bool need_exit) {
  const float4* W = P.walk + 2 * (size_t)j;
  const Rec g = unpack(__ldg(W), __ldg(W + 1));
  const float4* R = P.shade + (size_t)j * (ALLT_ROWS / 4);
  const float ox = ray.ox, oy = ray.oy, dx = ray.dx, dy = ray.dy;
  Pair pr = pair_at(g, ray);
  float inv = pr.denom == 0.0f ? 0.0f : 1.0f / pr.denom;
  float t_chord = pr.num_t * inv;
  float s = clamp01(pr.num_s * inv);

  const float4 r36 = __ldg(R + 9), r40 = __ldg(R + 10), r44 = __ldg(R + 11),
               r52 = __ldg(R + 13);
  float t0 = r52.y, dt = r52.z;
  float cx[4] = {r36.y, r36.w, r40.y, r40.w};
  float cy[4] = {r36.z, r40.x, r40.z, r44.x};
  float tau, t_ref, dbx, dby;
  bool hit = true;
  if (exact_refine) {
    float band = r52.w;
    float chord = sqrtf(g.ex * g.ex + g.ey * g.ey);
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
  // rows 4-6 / 7-9: left colour at the ends; 10-12 / 13-15: right colour
  const float4 r4 = __ldg(R + 1), r8 = __ldg(R + 2), r12 = __ldg(R + 3);
  float a;
  a = is_right ? r8.z : r4.x;
  h.r = a + ((is_right ? r12.y : r4.w) - a) * sf;
  a = is_right ? r8.w : r4.y;
  h.g = a + ((is_right ? r12.z : r8.x) - a) * sf;
  a = is_right ? r12.x : r4.z;
  h.b = a + ((is_right ? r12.w : r8.y) - a) * sf;
  const float4 r16 = __ldg(R + 4), r20 = __ldg(R + 5);
  h.blur = r16.x + (r16.y - r16.x) * sf;
  h.wm = r16.z + (r16.w - r16.z) * sf;
  h.wd = r20.x + (r20.y - r20.x) * sf;
  h.portal = need_exit && r20.z > 0.0f;
  if (h.portal) {
    // Portal exit (DeviceCode.cu:227-257), the reference's sin = nx*dy + ny*dx
    // and unnormalized rotated direction reproduced verbatim.
    float nlen = fmaxf(sqrtf(nx * nx + ny * ny), F32(1e-30));
    float nxu = nx / nlen, nyu = ny / nlen;
    float ray_cos = nxu * dx + nyu * dy;
    float ray_sin = nxu * dy + nyu * dx;
    const float4 r48 = __ldg(R + 12);
    float tcx[4] = {r44.y, r44.w, r48.y, r48.w};
    float tcy[4] = {r44.z, r48.x, r48.z, r52.x};
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

// One (ray, segment) test of closest_hit, for both chains; true when the
// strict chain's best moved.  A walk in ascending id order keeps the first
// minimum (TIE false); a walk in distance order takes the explicit
// tie-break, smaller key, then smaller id (TIE true), so the order in which
// segments are met, and meeting one twice, cannot change the winner.
template <bool EXACT, bool TIE>
__device__ __forceinline__ bool consider(const Rec& g, const Ray& r, float min_hit, Best& b) {
  const int j = g.id;
  Pair p = pair_at(g, r);
  float prod_s = p.num_s * (p.denom - p.num_s);
  float tcut = (p.num_t - min_hit * p.denom) * p.denom;
  bool sv = (prod_s >= 0.0f) && (tcut > 0.0f);
  bool bv = false, strict_moved = false;
  if (EXACT) {
    float h = g.band * r.band_scale;
    float had = h * fabsf(p.denom);
    bv = (prod_s + had + h * h >= 0.0f) && (tcut + had > 0.0f);
  }
  if (sv || bv) {
    float inv = p.denom == 0.0f ? 0.0f : 1.0f / p.denom;
    float s = p.num_s * inv;
    float t_est = (p.num_t - g.quad * s * (1.0f - s)) * inv;
    float key = fmaxf(t_est, F32(1e-30));
    if (EXACT && bv && (key < b.kb || (TIE && key == b.kb && j < b.wb))) {
      b.kb = key;
      b.wb = j;
    }
    if (sv && (key < b.ks || (TIE && key == b.ks && j < b.ws))) {
      b.ks = key;
      b.ws = j;
      strict_moved = true;
    }
  }
  return strict_moved;
}

// Every slot of a walk in slot order, for the lanes that ``need`` it: a
// list in id order (ties keep the first minimum) or a run of consecutive
// segments (the full sweep, a portal bounce, a chunk).  Called by all lanes.
template <bool EXACT, bool TIE>
__device__ __forceinline__ void walk_all(const Params& P, Piece* buf, const Span& sp, bool need,
                                         const Ray& r, Best& b, int lane) {
  const int n_pieces = (sp.n + WARP - 1) / WARP;
  for (int p = 0; p < n_pieces; ++p) {
    const Piece* pc = acquire(P, buf, sp, p, n_pieces, lane);
    if (need) {
      const int m = min(WARP, sp.n - p * WARP);
      for (int i = 0; i < m; ++i)
        consider<EXACT, TIE>(unpack(pc->rec[i][0], pc->rec[i][1]), r, P.min_hit, b);
    }
  }
  release();
}

// The per-ray clean rule on the two chains' winners (wb band, ws strict;
// without exact silhouettes only ws is set).
__device__ Shaded resolve(const Params& P, int wb, int ws, const Ray& r, bool need_exit) {
  if (!P.exact) {
    if (ws < 0) {
      Shaded miss;
      miss.hit = false;
      return miss;
    }
    return shade(P, ws, r, false, need_exit);
  }
  if (wb < 0) {
    Shaded miss;
    miss.hit = false;
    return miss;
  }
  if (ws >= 0 && wb == ws) return shade(P, ws, r, false, need_exit);
  Shaded hb = shade(P, wb, r, true, need_exit);
  if (!hb.hit && ws >= 0) return shade(P, ws, r, false, need_exit);
  return hb;
}

// ------------------------------------------------- distance-ordered walks
// Distance beyond which nothing can beat the ray's strict best: the best
// key or the scene exit, whichever is nearer, with the unit-direction slack.
__device__ __forceinline__ float walk_threshold(const Best& b, float texit) {
  return fminf(b.ks, texit) * F32(1.00001);
}

// Primary rays through a cell's distance-ordered tables: the capped list
// while its lower bounds stay below the ray's threshold, then, if segments
// were dropped and the horizon is still below it (or there is no list), the
// sorted chunk list under the same rule.  Called by all lanes; ``need``:
// this lane traces a ray.  The warp fetches a further piece of the list (a
// further chunk) while any lane still walks.  ``st``: this lane's counters.
template <bool EXACT, bool STATS>
__device__ __forceinline__ void walk_dist(const Params& P, Piece* buf, const Span& list, int cell,
                                          bool need, const Ray& r, Best& b, int* st, int lane) {
  // Where the ray leaves the scene's enclosing circle: no hit lies beyond
  // (every band-widened sub-segment is inside, the circle is convex), and
  // no key lies further beyond than the largest key slack.  A ray that
  // never enters, or leaves behind its origin, exits at 0.
  const float pcx = __ldg(P.circle) - r.ox, pcy = __ldg(P.circle + 1) - r.oy;
  const float cr = __ldg(P.circle + 2);
  const float bq = r.dx * pcx + r.dy * pcy;
  const float disc = bq * bq - (pcx * pcx + pcy * pcy - cr * cr);
  const float texit =
      fmaxf(disc >= 0.0f ? bq + sqrtf(fmaxf(disc, 0.0f)) : 0.0f, 0.0f) * F32(1.00002) +
      __ldg(P.circle + 3);

  bool into_chunks = need;
  if (P.cand_ids) {
    bool walking = need;
    int slots = 0;
    float thr = walk_threshold(b, texit);
    const int n_pieces = (list.n + WARP - 1) / WARP;
    for (int p = 0; p < n_pieces; ++p) {
      if (!__any_sync(FULL, walking)) break;
      const Piece* pc = acquire(P, buf, list, p, n_pieces, lane);
      if (walking) {
        const int m = min(WARP, list.n - p * WARP);
        for (int i = 0; i < m; ++i) {
          if (!(pc->lb[i] < thr)) {
            walking = false;
            break;
          }
          if (consider<EXACT, true>(unpack(pc->rec[i][0], pc->rec[i][1]), r, P.min_hit, b))
            thr = walk_threshold(b, texit);
          ++slots;
        }
      }
    }
    release();
    if (STATS) {
      // the warp walks as long as its longest walk: each ray counts that
      st[STAT_SLOTS] += slots;
      const int warp_max = __reduce_max_sync(FULL, slots);  // lanes without a ray: 0
      if (need) st[STAT_WARP_SLOTS] += warp_max;
    }
    into_chunks = need && P.chunk_ids && __ldg(P.cand_counts + cell) > P.cand_len &&
                  __ldg(P.cand_horizon + cell) < walk_threshold(b, texit);
  }
  if (P.chunk_ids && __any_sync(FULL, into_chunks)) {
    // lane l holds chunk c0 + l's id and bound; the warp walks chunk by chunk
    const int n = __ldg(P.chunk_counts + cell);
    const int* cids = P.chunk_ids + (size_t)cell * P.chunk_slots;
    const float* clbs = P.chunk_lbs + (size_t)cell * P.chunk_slots;
    int chunks = 0, pairs = 0;
    for (int c0 = 0; c0 < n; c0 += WARP) {
      if (!__any_sync(FULL, into_chunks)) break;
      const bool mine = c0 + lane < n;
      const int my_id = mine ? __ldg(cids + c0 + lane) : 0;
      const float my_lb = mine ? __ldg(clbs + c0 + lane) : 0.0f;
      const int cn = min(WARP, n - c0);
      for (int c = 0; c < cn; ++c) {
        const int cid = __shfl_sync(FULL, my_id, c);
        const float clb = __shfl_sync(FULL, my_lb, c);
        into_chunks = into_chunks && clb < walk_threshold(b, texit);
        if (!__any_sync(FULL, into_chunks)) break;
        const int j0 = cid * SEG_CHUNK;
        const Span chunk = {-1, j0, max(min(j0 + SEG_CHUNK, P.n_sub) - j0, 0)};
        walk_all<EXACT, true>(P, buf, chunk, into_chunks, r, b, lane);
        if (STATS && into_chunks) {
          ++chunks;
          pairs += chunk.n;
        }
      }
    }
    if (STATS) {
      st[STAT_CHUNKS] += chunks;
      st[STAT_CHUNK_PAIRS] += pairs;
      st[STAT_FALLBACK] += chunks > 0;
    }
  }
}

template <bool DIST, bool STATS>
__global__ void __launch_bounds__(BLOCK, DIST ? MIN_BLOCKS_DIST : MIN_BLOCKS_ID)
    trace_kernel(const Params P) {
  __shared__ Piece pieces[WARPS][NBUF];
  // The pixel's five sums and the portal chain of its current ray (colour
  // throughput, sum of inverse weights, blur product), per thread: written
  // at a hit, so they need not stay in registers through the walks.
  __shared__ float sums[5][BLOCK], chain[5][BLOCK];
  const int t = threadIdx.x;
  const int lane = t & (WARP - 1);
  Piece* const buf = pieces[t / WARP];  // this warp's

  // A lane whose pixel lies outside the band or the tile stays with its
  // warp (staging and votes need every lane) but traces nothing.
  const int tile = blockIdx.x;
  const int pin = blockIdx.y * BLOCK + threadIdx.x;  // pixel within tile
  const int tile_r = tile / P.tiles_x;
  const int tile_c = tile - tile_r * P.tiles_x;
  const int col = tile_c * TILE_W + (pin & (TILE_W - 1));
  const int row_rel = tile_r * P.tile_h + pin / TILE_W;
  const bool valid = pin < P.pxb && col < P.width && row_rel < P.n_rows;
  if (!__any_sync(FULL, valid)) return;
  const int row = P.px_start / P.width + row_rel;
  const uint32_t pixel = (uint32_t)row * (uint32_t)P.width + (uint32_t)col;

  const float ox0 = (float)(col - P.width / 2) * P.zoom + P.off_x;
  const float oy0 = P.save ? (float)((P.height - row) - P.height / 2) * P.zoom + P.off_y
                           : (float)(row - P.height / 2) * P.zoom + P.off_y;
  const bool need_exit = P.n_traces > 1;
  const Span sweep = {-1, 0, P.n_sub};  // portal bounces; no lists

#pragma unroll
  for (int i = 0; i < 5; ++i) sums[i][t] = 0.0f;
  int st[N_STATS] = {};
  for (int w = 0; w < P.n_wedges; ++w) {
    // the table cell: wedge-coarsened tables share one entry among 2^shift
    // adjacent wedges; raygen below keeps the fine wedge
    const int cell = tile * P.tab_wedges + (w >> P.wedge_shift);
    Span prim = sweep;  // the primary rays' walk
    if (DIST) {
      // empty cell: no segment (or chunk) passes, every primary ray misses
      if (__ldg((P.cand_ids ? P.cand_counts : P.chunk_counts) + cell) == 0) continue;
      if (P.cand_ids) {
        prim = Span{cell * P.cand_len, 0, min(__ldg(P.cand_counts + cell), P.cand_len)};
      }
    } else if (P.cand_ids) {
      const int n0 = min(__ldg(P.cand_counts + cell), P.cand_len);
      if (n0 == 0) continue;  // empty cell: every primary ray misses
      prim = Span{cell * P.cand_len, 0, n0};
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
      // ``alive``: this lane's ray is still being traced.  Every lane runs
      // every bounce the warp runs, so the walks stay warp-wide.
      bool alive = valid;
      for (int bounce = 0; bounce < P.n_traces; ++bounce) {
        if (!__any_sync(FULL, alive)) break;
        Ray r;
        r.ox = ox;
        r.oy = oy;
        r.dx = dx;
        r.dy = dy;
        r.cross = oy * dx - ox * dy;
        r.band_scale = P.exact ? sqrtf(dx * dx + dy * dy) : 0.0f;
        const float INF = __int_as_float(0x7f800000);
        Best b = {INF, INF, -1, -1};
        if (DIST && bounce == 0) {
          if (P.exact) {
            walk_dist<true, STATS>(P, buf, prim, cell, alive, r, b, st, lane);
          } else {
            walk_dist<false, STATS>(P, buf, prim, cell, alive, r, b, st, lane);
          }
          if (STATS && alive) {
            st[STAT_RAYS] += 1;
            const bool graze = P.exact && b.wb >= 0 && b.wb != b.ws;
            st[STAT_GRAZE] += graze;
            st[STAT_CLEAN] += !graze && b.ws >= 0;
          }
        } else {
          const Span& sp = bounce == 0 ? prim : sweep;
          if (P.exact) {
            walk_all<true, false>(P, buf, sp, alive, r, b, lane);
          } else {
            walk_all<false, false>(P, buf, sp, alive, r, b, lane);
          }
          if (STATS && bounce > 0) {
            // a bounce sweeps every sub-segment with the whole warp: each
            // lane that holds a pixel counts the sweep's slots
            if (valid) st[STAT_SWEEP_WARP_SLOTS] += P.n_sub;
            if (alive) {
              st[STAT_BOUNCE_RAYS] += 1;
              st[STAT_SWEEP_SLOTS] += P.n_sub;
            }
          }
        }
        if (!alive) continue;
        const Shaded h = resolve(P, b.wb, b.ws, r, need_exit);
        if (!h.hit) {
          alive = false;
          continue;
        }
        float w_self = h.wm * powf(h.t, -h.wd);
        // the chain so far: the identity before the first portal
        float fr = 1.0f, fg = 1.0f, fb = 1.0f, inv_w = 0.0f, blur_prod = 1.0f;
        if (bounce > 0) {
          fr = chain[0][t];
          fg = chain[1][t];
          fb = chain[2][t];
          inv_w = chain[3][t];
          blur_prod = chain[4][t];
        }
        if (!h.portal) {
          float w_final = 1.0f / (inv_w + 1.0f / w_self);
          sums[0][t] += (fr * h.r) * w_final;
          sums[1][t] += (fg * h.g) * w_final;
          sums[2][t] += (fb * h.b) * w_final;
          sums[3][t] += w_final;
          sums[4][t] += (blur_prod * h.blur) * w_final;
          alive = false;
          continue;
        }
        chain[0][t] = fr * h.r;
        chain[1][t] = fg * h.g;
        chain[2][t] = fb * h.b;
        chain[3][t] = inv_w + 1.0f / w_self;
        chain[4][t] = blur_prod * h.blur;
        ox = h.eox;
        oy = h.eoy;
        dx = h.edx;
        dy = h.edy;
      }
    }
  }
  if (!valid) return;
  const int p = row_rel * P.width + col;
#pragma unroll
  for (int i = 0; i < 5; ++i) P.out[i * P.n_px + p] = sums[i][t];
  if (STATS) {
#pragma unroll
    for (int i = 0; i < N_STATS; ++i) P.stats[i * P.n_px + p] += st[i];
  }
}

// The instantiations, in rtdc_trace_info's order: id order, distance order,
// distance order with counters.
constexpr int N_INSTANCES = 3;

template <bool DIST, bool STATS>
int info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, trace_kernel<DIST, STATS>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, trace_kernel<DIST, STATS>, BLOCK,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  const int v[6] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes, 0, blocks, BLOCK};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

// Records (scene/device.py): walk_records (s_pad, 8) and shade_records
// (s_pad, ALLT_ROWS) float32, 16-byte aligned.  Tables
// (trace_cuda.CandTables): id-ordered lists are cand_ids + cand_counts
// alone; distance-ordered tables add cand_lbs + cand_horizon and/or the
// chunk lists, with the scene circle.  ``tab_wedges``: the tables' wedge
// count, n_wedges >> their wedge shift (n_wedges for fine tables and
// without tables).  ``stats`` (distance order only)
// selects the counting instantiation.
extern "C" int rtdc_trace_sums(const float* walk_records, const float* shade_records, int s_pad,
                               int n_sub, const int* cand_ids, const int* cand_counts,
                               int cand_len, const float* cand_lbs, const float* cand_horizon,
                               const int* chunk_ids, const float* chunk_lbs,
                               const int* chunk_counts, int chunk_slots, const float* circle,
                               int* stats, float* out, int n_px, int width, int height,
                               int px_start, int tiles_x, int tiles_y, int tile_h, int pxb,
                               int rpp, int sw, int n_wedges, int tab_wedges, float zoom,
                               float off_x, float off_y, uint32_t frame, uint32_t seed,
                               int use_aa, int save, int exact, int n_traces, float min_hit,
                               void* stream) {
  if (width <= 0 || rpp <= 0 || sw <= 0 || pxb <= 0 || n_sub < 0 || n_sub > s_pad)
    return (int)cudaErrorInvalidValue;
  // the tables' wedges coarsen the fan's by a power of two
  if (tab_wedges <= 0 || tab_wedges > n_wedges) return (int)cudaErrorInvalidValue;
  int wedge_shift = 0;
  while ((tab_wedges << wedge_shift) < n_wedges) ++wedge_shift;
  if ((tab_wedges << wedge_shift) != n_wedges) return (int)cudaErrorInvalidValue;
  // list offsets are int (Span)
  if ((long long)tiles_x * tiles_y * tab_wedges * cand_len > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)walk_records | (uintptr_t)shade_records) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const bool dist = cand_lbs != nullptr || chunk_ids != nullptr;
  if (dist) {
    if (!circle) return (int)cudaErrorInvalidValue;
    if (cand_ids && !(cand_counts && cand_lbs && cand_horizon)) return (int)cudaErrorInvalidValue;
    if (chunk_ids && !(chunk_lbs && chunk_counts)) return (int)cudaErrorInvalidValue;
  } else if (stats || (cand_ids && !cand_counts)) {
    return (int)cudaErrorInvalidValue;
  }
  Params P;
  P.walk = reinterpret_cast<const float4*>(walk_records);
  P.shade = reinterpret_cast<const float4*>(shade_records);
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
  P.tab_wedges = tab_wedges;
  P.wedge_shift = wedge_shift;
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
  const dim3 grid(tiles_x * tiles_y, (pxb + BLOCK - 1) / BLOCK);
  const cudaStream_t cuda_stream = (cudaStream_t)stream;
  if (!dist) {
    trace_kernel<false, false><<<grid, BLOCK, 0, cuda_stream>>>(P);
  } else if (!stats) {
    trace_kernel<true, false><<<grid, BLOCK, 0, cuda_stream>>>(P);
  } else {
    trace_kernel<true, true><<<grid, BLOCK, 0, cuda_stream>>>(P);
  }
  return (int)cudaGetLastError();
}

// What the build made of instantiation i (rtdc_trace_info's order above)
// into out[6]: registers per thread, local (spilled) bytes per thread,
// static shared bytes per block, dynamic shared bytes per block (0), blocks
// per SM at BLOCK threads, BLOCK.  i < 0: the number of instantiations.
extern "C" int rtdc_trace_info(int i, int* out) {
  if (i < 0) return N_INSTANCES;
  if (i >= N_INSTANCES || out == nullptr) return (int)cudaErrorInvalidValue;
  return i == 0 ? info<false, false>(out) : i == 1 ? info<true, false>(out) : info<true, true>(out);
}

extern "C" const char* rtdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
