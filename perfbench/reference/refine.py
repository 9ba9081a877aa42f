"""Newton refinement of chord hits against the true cubic.

The flattened-segment intersection (ARCHITECTURE.md) finds the winner and an
O(1/K^2)-accurate hit; two Newton iterations on

    F(tau) = cross(d, B(tau) - o) = 0

(the ray-line/curve equation) move the hit onto the exact Bezier, eliminating
flattening facets under zoom and reproducing the reference's implicit-curve
intersection (OptiX round B-spline primitive) up to winner selection.

Plain PyTorch twin of the JAX package's ``ops/refine.py``, operation for
operation; the CUDA trace kernel (csrc/trace.cu ``refine_hit`` and
``refine_hit_exact``) evaluates the same expressions in the same order.
All functions are elementwise on broadcastable tensors.
"""

from __future__ import annotations

import torch

# One iteration suffices: the chord start point is O(1/K^2) px from the
# curve, and Newton convergence is quadratic — the residual lands far below
# a hundredth of a pixel.
NEWTON_ITERS = 1


def bezier_and_derivative(cx, cy, tau):
    """cx, cy: tuples of the 4 control coordinates (arrays). Returns
    (Bx, By, dBx, dBy) at tau."""
    x0, x1, x2, x3 = cx
    y0, y1, y2, y3 = cy
    mt = 1.0 - tau
    b0 = mt * mt * mt
    b1 = 3.0 * mt * mt * tau
    b2 = 3.0 * mt * tau * tau
    b3 = tau * tau * tau
    bx = b0 * x0 + b1 * x1 + b2 * x2 + b3 * x3
    by = b0 * y0 + b1 * y1 + b2 * y2 + b3 * y3
    d0 = 3.0 * mt * mt
    d1 = 6.0 * mt * tau
    d2 = 3.0 * tau * tau
    dbx = d0 * (x1 - x0) + d1 * (x2 - x1) + d2 * (x3 - x2)
    dby = d0 * (y1 - y0) + d1 * (y2 - y1) + d2 * (y3 - y2)
    return bx, by, dbx, dby


def bezier_derivative_only(cx, cy, tau):
    """(dBx, dBy) at tau via the power basis — for consumers that only need
    the tangent (exact-silhouette shading), ~60% cheaper than
    bezier_and_derivative."""
    x0, x1, x2, x3 = cx
    y0, y1, y2, y3 = cy
    dx0 = 3.0 * (x1 - x0)
    dx1 = 6.0 * (x2 - 2.0 * x1 + x0)
    dx2 = 3.0 * (x3 - 3.0 * x2 + 3.0 * x1 - x0)
    dy0 = 3.0 * (y1 - y0)
    dy1 = 6.0 * (y2 - 2.0 * y1 + y0)
    dy2 = 3.0 * (y3 - 3.0 * y2 + 3.0 * y1 - y0)
    return (dx2 * tau + dx1) * tau + dx0, (dy2 * tau + dy1) * tau + dy0


def _newton(cx, cy, tau0, ox, oy, dx, dy, iters):
    """Shared Newton loop on F(tau) = cross(d, B(tau) - o).  Returns
    (tau, bx, by, dbx, dby, f, df) at the final iterate plus the tau0
    evaluation (the fallback)."""
    b0 = bezier_and_derivative(cx, cy, tau0)
    tau, (bx, by, dbx, dby) = tau0, b0
    for _ in range(iters):
        f = dx * (by - oy) - dy * (bx - ox)
        df = dx * dby - dy * dbx
        step = torch.where(torch.abs(df) > 1e-12, f / torch.where(df == 0.0, 1.0, df), 0.0)
        tau = torch.clamp(tau - step, 0.0, 1.0)
        bx, by, dbx, dby = bezier_and_derivative(cx, cy, tau)
    f = dx * (by - oy) - dy * (bx - ox)
    df = dx * dby - dy * dbx
    return tau, bx, by, dbx, dby, f, df, b0


def refine_hit(cx, cy, tau0, ox, oy, dx, dy, t_chord, min_hit):
    """Newton-refine the cubic parameter from the chord estimate tau0.

    Returns (tau, t_ref, bx, by, dbx, dby): the refined parameter, the hit
    distance in ray-parameter units (valid for non-unit directions:
    t = (B - o) . d / (d . d)), and the exact position/derivative there.
    Falls back to (tau0, t_chord) when the ray runs nearly parallel to the
    curve tangent (|dF| ~ 0) or refinement leaves the valid range.
    """
    tau, bx, by, dbx, dby, f, _, b0 = _newton(
        cx, cy, tau0, ox, oy, dx, dy, NEWTON_ITERS
    )
    dd = dx * dx + dy * dy
    t_ref = ((bx - ox) * dx + (by - oy) * dy) / torch.where(dd == 0.0, 1.0, dd)
    # Residual after refinement; a diverged ray keeps its chord solution.
    good = (t_ref >= min_hit) & (torch.abs(f) < torch.abs(t_chord) * 0.05 + 1.0)
    tau = torch.where(good, tau, tau0)
    t_ref = torch.where(good, t_ref, t_chord)
    out = tuple(torch.where(good, a, b) for a, b in zip((bx, by, dbx, dby), b0))
    return tau, t_ref, out[0], out[1], out[2], out[3]


# Exact-silhouette mode uses one extra iteration: band candidates start up
# to the full sagitta away, and the accept test leans on the residual.
NEWTON_ITERS_EXACT = 2

# Isolation-window margin scale (x band * dt / chord_len, see
# refine_hit_exact): covers crossings within MARGIN_SCALE/2 capsule-band
# reaches of a window edge, so near-tied adjacent-window winners resolve the
# same crossing.  Larger values are MORE tie-robust but LESS accurate: a
# band-accepted winner with no own-window crossing should usually fall back
# to the strict chain, and a wide margin instead lets it claim a farther
# crossing from a neighbouring window ("stealing"), measured at -1.1% deep-
# zoom oracle agreement for scale 2.  0.25 measured best on the deep-zoom
# oracle (tests/test_silhouettes.py) while still covering fp-level edge ties.
MARGIN_SCALE = 0.25

# Bisection iterations per monotone interval in refine_hit_exact.  After B
# halvings of a <= (window + 2*margin) interval the bracket is ~dt/2^B wide;
# the two clipped Newton polish steps then converge quadratically from
# inside it.  5 is conservative; perf probes can lower it (the deep-zoom
# oracle test pins the accuracy floor).
BISECT_ITERS = 5


def refine_hit_exact(cx, cy, tau0, win0, win_dt, ox, oy, dx, dy, t_chord, min_hit,
                     margin=0.0):
    """Exact nearest crossing of the ray with the winner's cubic — the
    decision procedure for exact silhouettes.

    A grazing ray can cross the cubic twice within one parameter window
    (silhouette bumps), and local Newton from the chord estimate lands on
    whichever root is downhill — possibly the farther one.  So isolate ALL
    real roots of the cubic polynomial F(tau) = cross(d, B(tau) - o) over
    the winner's parameter window [win0, win0 + win_dt]: split at the roots
    of the quadratic F' (closed form) into <= 3 monotone intervals, bisect
    each sign-changing interval, polish with two Newton steps, and take the
    smallest root with t >= min_hit.  The window restriction keeps
    attribution consistent — each window candidate answers only for its own
    crossings (crossings in neighbouring windows belong to those windows'
    candidates, which the conservative band always also accepts).

    ``margin`` widens the isolation window symmetrically (clipped to the
    cubic's [0, 1]).  Band acceptance is tie-prone: adjacent sub-segments of
    one cubic both accept a crossing near their shared window edge with
    ordering keys equal to rounding, and the two backends round differently
    (exact division + argmin vs approximate reciprocal + 2^-17-quantized
    packed key).  The margin makes EITHER winner resolve that edge crossing
    to the same root, so near-tied winner flips can no longer flip hit/side.
    Callers pass ~2 * band * dt / chord_len — the parameter reach of a point
    within the capsule band of this sub-segment's chord.

    Returns (tau, t_ref, bx, by, dbx, dby, conv); ``conv`` false means no
    crossing at t >= min_hit exists on this cubic (the caller then falls
    back to the strict chain or a miss).  Non-converged rays keep the chord
    solution (tau0, t_chord) for downstream shading.
    """
    x0, x1, x2, x3 = cx
    y0, y1, y2, y3 = cy
    # Bernstein -> power-basis coefficients of F and of T(tau) = (B - o).d
    b0_ = dx * (y0 - oy) - dy * (x0 - ox)
    b1_ = dx * (y1 - oy) - dy * (x1 - ox)
    b2_ = dx * (y2 - oy) - dy * (x2 - ox)
    b3_ = dx * (y3 - oy) - dy * (x3 - ox)
    a0 = b0_
    a1 = 3.0 * (b1_ - b0_)
    a2 = 3.0 * (b2_ - 2.0 * b1_ + b0_)
    a3 = b3_ - 3.0 * b2_ + 3.0 * b1_ - b0_
    d0_ = dx * (x0 - ox) + dy * (y0 - oy)
    d1_ = dx * (x1 - ox) + dy * (y1 - oy)
    d2_ = dx * (x2 - ox) + dy * (y2 - oy)
    d3_ = dx * (x3 - ox) + dy * (y3 - oy)
    e0 = d0_
    e1 = 3.0 * (d1_ - d0_)
    e2 = 3.0 * (d2_ - 2.0 * d1_ + d0_)
    e3 = d3_ - 3.0 * d2_ + 3.0 * d1_ - d0_
    dd = dx * dx + dy * dy
    inv_dd = 1.0 / torch.where(dd == 0.0, 1.0, dd)

    def F(tau):
        return ((a3 * tau + a2) * tau + a1) * tau + a0

    def Fp(tau):
        return (3.0 * a3 * tau + 2.0 * a2) * tau + a1

    def T(tau):
        return (((e3 * tau + e2) * tau + e1) * tau + e0) * inv_dd

    # Monotone-interval boundaries: roots of F' (stable quadratic formula;
    # no real roots or degenerate quadratic -> boundaries collapse into the
    # [0, 1] endpoints and the interval simply becomes empty).
    qa = 3.0 * a3
    qb = 2.0 * a2
    qc = a1
    disc = qb * qb - 4.0 * qa * qc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    qq = -0.5 * (qb + torch.where(qb >= 0.0, sq, -sq))
    rA = torch.where(torch.abs(qa) > 1e-30, qq / torch.where(qa == 0.0, 1.0, qa), -1.0)
    rB = torch.where(torch.abs(qq) > 1e-30, qc / torch.where(qq == 0.0, 1.0, qq), -1.0)
    lo_w = torch.clamp(win0 - margin, 0.0, 1.0)
    hi_w = torch.clamp(win0 + win_dt + margin, 0.0, 1.0)
    bad = disc < 0.0
    rA = torch.clamp(torch.where(bad, lo_w, rA), lo_w, hi_w)
    rB = torch.clamp(torch.where(bad, lo_w, rB), lo_w, hi_w)
    r1 = torch.minimum(rA, rB)
    r2 = torch.maximum(rA, rB)

    def root_in(lo, hi):
        """Bisect + Newton-polish the (single) root of monotone F in
        [lo, hi]; returns (found, tau)."""
        flo = F(lo)
        fhi = F(hi)
        found = (flo * fhi <= 0.0) & (hi > lo)
        a, b, fa = lo, hi, flo
        for _ in range(BISECT_ITERS):
            mid = 0.5 * (a + b)
            fm = F(mid)
            left = fa * fm <= 0.0
            a, b, fa = (
                torch.where(left, a, mid),
                torch.where(left, mid, b),
                torch.where(left, fa, fm),
            )
        tau = 0.5 * (a + b)
        for _ in range(2):
            fp = Fp(tau)
            step = F(tau) / torch.where(fp == 0.0, 1.0, fp)
            tau = torch.clamp(tau - torch.where(torch.abs(fp) > 1e-30, step, 0.0), a, b)
        return found, tau

    best_t = torch.full_like(tau0, float("inf"))
    best_tau = tau0
    for lo, hi in ((lo_w + 0.0 * r1, r1), (r1, r2), (r2, hi_w + 0.0 * r2)):
        found, tau_i = root_in(lo, hi)
        t_i = T(tau_i)
        ok = found & (t_i >= min_hit) & (t_i < best_t)
        best_t = torch.where(ok, t_i, best_t)
        best_tau = torch.where(ok, tau_i, best_tau)

    conv = torch.isfinite(best_t)
    tau = torch.where(conv, best_tau, tau0)
    t_ref = torch.where(conv, best_t, t_chord)
    # Only the tangent is consumed downstream (side test / portal frame);
    # the hit point is o + t_ref * d.
    dbx, dby = bezier_derivative_only(cx, cy, tau)
    return tau, t_ref, None, None, dbx, dby, conv
