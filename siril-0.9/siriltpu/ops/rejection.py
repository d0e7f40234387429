"""Pixel-rejection kernels: the 5 rejection algorithms of mean-with-
rejection stacking, vectorized over pixels as masked fixed-point loops.

Reference: src/stacking/stacking.c:1128-1186 (clip predicates) and
:1656-1788 (per-pixel loops). Semantics frozen:

- the per-pixel cross-frame vector is sorted, then iteratively clipped
  around the GSL sorted-median using the GSL SAMPLE standard deviation
  (N-1 denominator, gsl_stats_ushort_sd);
- loops run while any pixel was rejected and more than 3 survive
  (``while (n > 0 && N > 3)``);
- flagging stops early within a pass once ``N - r <= 4`` where ``r``
  accumulates across passes (stacking.c:1684-1688, 1737, 1748). In the
  reference, positions after the break keep *stale* flags in the reused
  ``rejected[]`` buffer, and the removal loop consumes them WITHOUT
  counting them in the rejection stats; we model the buffer exactly
  (positional, by rank) with a zero initial state -- the cross-pixel
  carryover of the C is workload-dependent and pinned to zeros by the
  parity goldens (see _stale_pass and parity_harness/harness.c).
- SIGMEDIAN replaces rejected values by round_to_WORD(median) instead of
  removing (:1696-1708);
- WINSORIZED iterates (clamp to median±1.5σ, re-measure median and
  1.134·sd) until |σ−σ₀|/σ₀ ≤ 5·10⁻⁴, then sigma-clips the *original*
  values with the converged σ and the winsorized median (:1710-1748);
- LINEARFIT fits value-vs-rank by least squares, σ = mean |residual|
  (:1750-1783);
- PERCENTILE is a single pass on relative distance from the median
  (:1130-1143), removing only if N > 1 (:1667-1673).
- final pixel = round_to_WORD(mean of survivors) (:1790-1794).

Device structure: sort ONCE along the frame axis (removal preserves
sorted order), keep a validity mask; every order statistic is a
cumsum-gather; iteration is a ``lax.while_loop`` whose condition is a
global any-reduce, with converged pixels frozen. Only SIGMEDIAN mutates
values and needs a per-iteration re-sort.

Shapes: ``vals`` is (F, P) float32 — F frames, P pixels (any flattened
block). uint16 values are exactly representable in f32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from siriltpu.ops.pallas.reject_stack import (fused_applies, fused_stack,
                                              sqrt_rn)
from siriltpu.ops.sortnet import sort_axis0
from siriltpu.utils.rounding import round_to_word, round_to_word_f

Array = jnp.ndarray

_INVALID = jnp.float32(1e9)
# Safety bound only: the reference loops are data-terminating (every pass
# removes >= 1 element, so <= F passes for the removal-based algorithms;
# converged pixels are frozen, so a high bound costs nothing once all
# pixels are done). 50 was too low: a 128-frame golden vector legitimately
# takes 61 passes (caught by tests/test_c_goldens.py).
MAX_ITERS = 512


# ------------------------------------------------------------- mask helpers

def _sort_with_mask(vals: Array, valid: Array) -> Tuple[Array, Array]:
    """Sort values ascending with invalid entries pushed to the end."""
    keys = jnp.where(valid, vals, _INVALID)
    s = sort_axis0(keys)
    return s, s < _INVALID / 2


def _kth_valid(vals: Array, cum: Array, k: Array, valid: Array) -> Array:
    """Value of the k-th (0-based) valid element per pixel.

    ``cum`` is the inclusive cumsum of the validity mask along axis 0.
    The hit must be restricted to VALID slots: invalid slots replicate the
    cum value of the preceding valid slot, so ``cum == k+1`` alone matches
    extra positions whenever the mask is interspersed (e.g. after a
    stale-flag removal in the middle of the sorted window) -- summing
    those duplicates silently corrupted the order statistic.
    """
    hit = (cum == (k[None, :] + 1)) & valid
    return jnp.sum(jnp.where(hit, vals, 0.0), axis=0)


def _gsl_median(vals: Array, valid: Array, n: Array) -> Array:
    """GSL sorted-median over the valid elements (mean of the two middle
    order statistics for even n)."""
    cum = jnp.cumsum(valid.astype(jnp.int32), axis=0)
    k1 = (n - 1) // 2
    k2 = n // 2
    v1 = _kth_valid(vals, cum, k1, valid)
    v2 = _kth_valid(vals, cum, k2, valid)
    return jnp.where(n > 0, 0.5 * (v1 + v2), 0.0)


def _gsl_sd(vals: Array, valid: Array, n: Array) -> Array:
    """gsl_stats_ushort_sd over the valid subset.

    Precondition: ``vals`` are INTEGER-valued f32 (rejection always runs
    on round_to_WORD'd values, stacking.c:1620-1651; anchor shifts keep
    integrality). All sums are computed EXACTLY in int32 -- deviations
    are centered on the middle order statistic, and the squares use a
    hi/lo 8-bit split so every accumulator stays below 2^31 -- leaving
    only one final f32 combine (~2^-24 relative sigma error vs the C's
    double recurrence). The old f32 running sums lost ~5e-4 relative
    sigma on near-saturated data, flipping clip decisions vs the
    compiled reference (caught by tests/test_c_goldens.py)."""
    nf = n.astype(jnp.float32)
    cum = jnp.cumsum(valid.astype(jnp.int32), axis=0)
    anchor = jnp.floor(_kth_valid(vals, cum, n // 2, valid)).astype(jnp.int32)
    vi = jnp.where(valid, vals, 0.0).astype(jnp.int32)
    d = jnp.where(valid, vi - anchor[None, :], 0)
    s1 = jnp.sum(d, axis=0)                        # exact: |s1| <= F*65535
    ad = jnp.abs(d)
    hi8 = ad >> 8
    lo8 = ad & 255
    s2 = (jnp.sum(hi8 * hi8, axis=0).astype(jnp.float32) * 65536.0
          + jnp.sum(hi8 * lo8, axis=0).astype(jnp.float32) * 512.0
          + jnp.sum(lo8 * lo8, axis=0).astype(jnp.float32))
    s1f = s1.astype(jnp.float32)
    var = (s2 - s1f * s1f / jnp.maximum(nf, 1.0)) / jnp.maximum(nf - 1.0, 1.0)
    return jnp.where(n > 1, sqrt_rn(jnp.maximum(var, 0.0)), 0.0)


def _mean_of_survivors(vals: Array, valid: Array) -> Array:
    """round_to_WORD(sum / N) with integer-valued survivors: computed in
    exact int32 arithmetic (floor(s/n + 0.5) == (2s + n) // (2n)), immune
    to the f32 division rounding that can flip the .5 boundary."""
    n = jnp.sum(valid, axis=0).astype(jnp.int32)
    s = jnp.sum(jnp.where(valid, vals, 0.0).astype(jnp.int32), axis=0)
    m = jnp.where(n > 0, (2 * s + n) // jnp.maximum(2 * n, 1), 0)
    return jnp.clip(m, 0, 65535).astype(jnp.uint16)


def _stale_pass(valid: Array, buf: Array, r_prev: Array, low: Array,
                high: Array, n: Array):
    """One flag+removal pass with the C's full quirk set
    (stacking.c:1674-1694): the flag scan walks the compacted survivor
    stack (= the valid slots in sorted order) writing into a POSITIONAL
    buffer ``rejected[rank]``, counting ``r`` cumulatively, and breaking
    once ``N - r <= 4``; the removal loop then reads ``rejected[rank]``
    for ALL ranks -- positions past the break point retain STALE flags
    from the previous pass, which remove elements without being counted
    in the rejection stats.

    ``buf`` is the (F, P) int8 positional buffer (index = rank among the
    currently valid elements). Returns (new_valid, new_buf, r_new,
    removed, cnt_low, cnt_high).
    """
    f, p = valid.shape
    fresh = low | high
    c = jnp.cumsum(fresh.astype(jnp.int32), axis=0)
    # break at rank j iff after counting j's flag, N - r <= 4; only valid
    # slots are scan steps. Element hosting the break IS visited.
    broke = ((n[None, :] - (r_prev[None, :] + c)) <= 4) & valid
    broke_before = jnp.concatenate(
        [jnp.zeros_like(broke[:1]),
         jnp.cumsum(broke.astype(jnp.int32), axis=0)[:-1] > 0], axis=0)
    visited = valid & ~broke_before
    cnt_l = jnp.sum(low & visited, axis=0).astype(jnp.int32)
    cnt_h = jnp.sum(high & visited, axis=0).astype(jnp.int32)
    r_new = r_prev + jnp.sum(fresh & visited, axis=0).astype(jnp.int32)
    cum = jnp.cumsum(valid.astype(jnp.int32), axis=0)
    rank = cum - 1
    buf_at = jnp.take_along_axis(buf, jnp.clip(rank, 0, f - 1), axis=0)
    sign = jnp.where(low, -1, jnp.where(high, 1, 0)).astype(jnp.int8)
    entry = jnp.where(visited, sign, buf_at)
    remove = valid & (entry != 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (f, p), 1)
    idx = jnp.where(valid, rank, f)  # invalid slots write out of bounds
    buf_new = buf.at[idx, cols].set(jnp.where(valid, entry, 0), mode="drop")
    new_valid = valid & ~remove
    removed = jnp.sum(remove, axis=0).astype(jnp.int32)
    return new_valid, buf_new, r_new, removed, cnt_l, cnt_h


def _sigma_flags(vals: Array, valid: Array, median: Array, sigma: Array,
                 siglow: float, sighigh: float):
    """sigma_clipping (stacking.c:1148-1160): returns (low, high) flags."""
    low = (median[None, :] - vals > siglow * sigma[None, :]) & valid
    high = (vals - median[None, :] > sighigh * sigma[None, :]) & valid
    return low, high


# ------------------------------------------------------------- algorithms

@functools.partial(jax.jit,
                   static_argnames=("siglow", "sighigh", "presorted"))
def reject_sigma(vals: Array, siglow: float, sighigh: float,
                 active: Array = None, presorted: bool = False):
    """SIGMA rejection (stacking.c:1674-1694). Returns (valid mask over the
    SORTED values, sorted values, rejl, rejh counts per pixel).

    ``active`` (P,) bool: pixels to process; inactive pixels start done
    (their valid mask stays all-true and counters stay 0), making this
    cheap to use as an exact fallback for the window kernel's rare
    degenerate pixels. ``presorted`` skips the sort when the caller
    already sorted along axis 0."""
    f, p = vals.shape
    sv = vals if presorted else sort_axis0(vals)
    valid0 = jnp.ones((f, p), dtype=bool)
    done0 = jnp.zeros(p, bool) if active is None else ~active

    def cond(state):
        _, _, _, done, _, _, it = state
        return (~jnp.all(done)) & (it < MAX_ITERS)

    def body(state):
        valid, r, buf, done, rejl, rejh, it = state
        n = jnp.sum(valid, axis=0).astype(jnp.int32)
        sigma = _gsl_sd(sv, valid, n)
        median = _gsl_median(sv, valid, n)
        low, high = _sigma_flags(sv, valid, median, sigma, siglow, sighigh)
        new_valid, new_buf, r_new, removed, cnt_l, cnt_h = _stale_pass(
            valid, buf, r, low, high, n)
        n_new = n - removed
        # freeze pixels that are done
        upd = ~done
        valid = jnp.where(upd[None, :], new_valid, valid)
        buf = jnp.where(upd[None, :], new_buf, buf)
        rejl = rejl + jnp.where(upd, cnt_l, 0)
        rejh = rejh + jnp.where(upd, cnt_h, 0)
        r = jnp.where(upd, r_new, r)
        done = done | (removed == 0) | (n_new <= 3)
        return valid, r, buf, done, rejl, rejh, it + 1

    state = (valid0, jnp.zeros(p, jnp.int32), jnp.zeros((f, p), jnp.int8),
             done0, jnp.zeros(p, jnp.int32),
             jnp.zeros(p, jnp.int32), jnp.int32(0))
    valid, r, buf, done, rejl, rejh, _ = jax.lax.while_loop(cond, body, state)
    return valid, sv, rejl, rejh


@functools.partial(jax.jit, static_argnames=("siglow", "sighigh"))
def reject_sigmedian(vals: Array, siglow: float, sighigh: float):
    """SIGMEDIAN (stacking.c:1696-1708): rejected values replaced by
    round_to_WORD(median); nothing removed. Returns (valid, values, rejl, rejh)."""
    f, p = vals.shape
    sv = sort_axis0(vals)
    valid = jnp.ones((f, p), dtype=bool)
    n = jnp.full((p,), f, jnp.int32)

    def cond(state):
        _, done, _, _, it = state
        return (~jnp.all(done)) & (it < MAX_ITERS)

    def body(state):
        v, done, rejl, rejh, it = state
        sigma = _gsl_sd(v, valid, n)
        median = _gsl_median(v, valid, n)
        low, high = _sigma_flags(v, valid, median, sigma, siglow, sighigh)
        flags = low | high
        nrep = jnp.sum(flags, axis=0).astype(jnp.int32)
        medw = round_to_word_f(median)
        v_new = jnp.where(flags & ~done[None, :], medw[None, :], v)
        v_new = sort_axis0(v_new)
        rejl = rejl + jnp.where(~done, jnp.sum(low, axis=0), 0)
        rejh = rejh + jnp.where(~done, jnp.sum(high, axis=0), 0)
        done = done | (nrep == 0) | (n <= 3)
        return v_new, done, rejl, rejh, it + 1

    state = (sv, jnp.zeros(p, bool), jnp.zeros(p, jnp.int32),
             jnp.zeros(p, jnp.int32), jnp.int32(0))
    v, done, rejl, rejh, _ = jax.lax.while_loop(cond, body, state)
    return valid, v, rejl, rejh


@functools.partial(jax.jit, static_argnames=("siglow", "sighigh"))
def reject_winsorized(vals: Array, siglow: float, sighigh: float):
    """WINSORIZED sigma clipping (stacking.c:1710-1748).

    float32 precision guard: the 1.134-sigma fixed-point iteration with
    its 5e-4 convergence test amplifies f32 rounding at large pixel
    values (ulp(65535) ~ 0.004 vs sigma ~ units), so all math runs
    per-pixel CENTERED on an integer anchor c (the middle order
    statistic): every step is shift-equivariant, and the word-grid clamp
    uses the exact identity floor(x + c + 0.5) = c + floor(x + 0.5) for
    integer c. For raw uint16 data this makes the kernel exact; for
    normalized (non-integer) data it stops error growth with magnitude.
    """
    f, p = vals.shape
    sv_orig = sort_axis0(vals)
    anchor = jnp.floor(sv_orig[f // 2])  # (p,) integer-valued
    sv = sv_orig - anchor[None, :]
    lo_clip = -anchor          # word-grid 0 in the shifted domain
    hi_clip = 65535.0 - anchor  # word-grid 65535 in the shifted domain

    def round_shift(x):
        r = jnp.floor(x + 0.5)
        r = jnp.where(x <= lo_clip, lo_clip, r)
        return jnp.where(x > hi_clip, hi_clip, r)

    valid0 = jnp.ones((f, p), dtype=bool)

    def winsor_converge(valid, n):
        """Inner loop: winsorize until sigma converges. Returns (median, sigma)."""
        sigma = _gsl_sd(sv, valid, n)
        median = _gsl_median(sv, valid, n)
        w0 = jnp.where(valid, sv, _INVALID)

        def wcond(ws):
            _, _, _, conv, it = ws
            return (~jnp.all(conv)) & (it < MAX_ITERS)

        def wbody(ws):
            w, med, sig, conv, it = ws
            m0 = med - 1.5 * sig
            m1 = med + 1.5 * sig
            wv = jnp.where(w < _INVALID / 2,
                           jnp.where(w < m0[None, :], round_shift(m0)[None, :],
                                     jnp.where(w > m1[None, :],
                                               round_shift(m1)[None, :], w)),
                           w)
            # no re-sort needed: clamping tails to [m0, m1] is monotone
            # non-decreasing, so a sorted vector stays sorted (and the
            # _INVALID sentinels stay at the top)
            wvalid = wv < _INVALID / 2
            med_new = _gsl_median(wv, wvalid, n)
            sig_new = 1.134 * _gsl_sd(wv, wvalid, n)
            newconv = jnp.where(sig > 0,
                                jnp.abs(sig_new - sig) / jnp.maximum(sig, 1e-30) <= 0.0005,
                                True)
            # freeze converged pixels
            w = jnp.where(conv[None, :], w, wv)
            med = jnp.where(conv, med, med_new)
            sig = jnp.where(conv, sig, sig_new)
            conv = conv | newconv
            return w, med, sig, conv, it + 1

        ws = (w0, median, sigma, jnp.zeros(p, bool), jnp.int32(0))
        _, med, sig, _, _ = jax.lax.while_loop(wcond, wbody, ws)
        return med, sig

    def cond(state):
        _, _, _, done, _, _, it = state
        return (~jnp.all(done)) & (it < MAX_ITERS)

    def body(state):
        valid, r, buf, done, rejl, rejh, it = state
        n = jnp.sum(valid, axis=0).astype(jnp.int32)
        median, sigma = winsor_converge(valid, n)
        low, high = _sigma_flags(sv, valid, median, sigma, siglow, sighigh)
        new_valid, new_buf, r_new, removed, cnt_l, cnt_h = _stale_pass(
            valid, buf, r, low, high, n)
        n_new = n - removed
        upd = ~done
        valid = jnp.where(upd[None, :], new_valid, valid)
        buf = jnp.where(upd[None, :], new_buf, buf)
        rejl = rejl + jnp.where(upd, cnt_l, 0)
        rejh = rejh + jnp.where(upd, cnt_h, 0)
        r = jnp.where(upd, r_new, r)
        done = done | (removed == 0) | (n_new <= 3)
        return valid, r, buf, done, rejl, rejh, it + 1

    state = (valid0, jnp.zeros(p, jnp.int32), jnp.zeros((f, p), jnp.int8),
             jnp.zeros(p, bool), jnp.zeros(p, jnp.int32),
             jnp.zeros(p, jnp.int32), jnp.int32(0))
    valid, r, buf, done, rejl, rejh, _ = jax.lax.while_loop(cond, body, state)
    return valid, sv_orig, rejl, rejh


#: residual/sigma ratios closer than this to the clip threshold are
#: knife-edges the f32 kernel cannot decide reliably against the C's
#: f64 math; such pixels are flagged for the exact host re-run
#: (linearfit_hybrid_block). The f32 relative error of the fit+ratio
#: chain is ~F·2⁻²⁴ ≈ 1e-5 at F=100; 1e-4 leaves a 10× guard band
#: while flagging ~nothing on real (continuous-noise) data.
LINEARFIT_KNIFE_EPS = 1e-4


@functools.partial(jax.jit, static_argnames=("siglow", "sighigh"))
def reject_linearfit(vals: Array, siglow: float, sighigh: float):
    """LINEARFIT rejection (stacking.c:1750-1783): least-squares line over
    (rank, sorted value), sigma = mean |residual|, clip by residual.

    Returns ``(valid, sorted_vals, rejlow, rejhigh, knife)`` — ``knife``
    marks pixels whose clip decision came within LINEARFIT_KNIFE_EPS of
    the threshold at any iteration (re-run those via the f64 oracle for
    bit-exactness, see linearfit_hybrid_block)."""
    f, p = vals.shape
    sv_orig = sort_axis0(vals)
    # f32 guard (as in reject_winsorized): the fit and its residual test
    # are shift-equivariant, so center on an integer anchor to keep
    # intercept/residual math away from ulp(65535) ~ 0.004 granularity.
    anchor = jnp.floor(sv_orig[f // 2])
    sv = sv_orig - anchor[None, :]
    valid0 = jnp.ones((f, p), dtype=bool)

    def cond(state):
        _, _, _, done, _, _, _, it = state
        return (~jnp.all(done)) & (it < MAX_ITERS)

    def body(state):
        valid, r, buf, done, rejl, rejh, knife, it = state
        n = jnp.sum(valid, axis=0).astype(jnp.int32)
        nf = n.astype(jnp.float32)
        cum = jnp.cumsum(valid.astype(jnp.int32), axis=0)
        rank = jnp.where(valid, (cum - 1).astype(jnp.float32), 0.0)
        y = jnp.where(valid, sv, 0.0)
        sx = jnp.sum(rank, axis=0)
        sy = jnp.sum(y, axis=0)
        xm = sx / jnp.maximum(nf, 1.0)
        ym = sy / jnp.maximum(nf, 1.0)
        dx = jnp.where(valid, rank - xm[None, :], 0.0)
        dy = jnp.where(valid, sv - ym[None, :], 0.0)
        ssxx = jnp.sum(dx * dx, axis=0)
        a = jnp.where(ssxx > 0, jnp.sum(dx * dy, axis=0) / jnp.maximum(ssxx, 1e-30), 0.0)
        b = ym - a * xm
        fitv = a[None, :] * rank + b[None, :]
        resid = jnp.where(valid, jnp.abs(sv - fitv), 0.0)
        sigma = jnp.sum(resid, axis=0) / jnp.maximum(nf, 1.0)
        safe_sig = jnp.maximum(sigma, 1e-30)
        ratio_lo = (fitv - sv) / safe_sig[None, :]
        ratio_hi = (sv - fitv) / safe_sig[None, :]
        low = (ratio_lo > siglow) & valid
        high = (ratio_hi > sighigh) & valid
        sig_pos = (sigma > 0)[None, :]
        low = low & sig_pos
        high = high & sig_pos
        # knife-edge detection: any frame's clip ratio within EPS of its
        # threshold on an active pixel means f32 may disagree with the
        # C's f64 decision — flag the pixel for the exact re-run
        m = jnp.where(valid & sig_pos,
                      jnp.minimum(jnp.abs(ratio_lo - siglow),
                                  jnp.abs(ratio_hi - sighigh)),
                      jnp.inf)
        knife = knife | (~done & (jnp.min(m, axis=0) < LINEARFIT_KNIFE_EPS))
        new_valid, new_buf, r_new, removed, cnt_l, cnt_h = _stale_pass(
            valid, buf, r, low, high, n)
        n_new = n - removed
        upd = ~done
        valid = jnp.where(upd[None, :], new_valid, valid)
        buf = jnp.where(upd[None, :], new_buf, buf)
        rejl = rejl + jnp.where(upd, cnt_l, 0)
        rejh = rejh + jnp.where(upd, cnt_h, 0)
        r = jnp.where(upd, r_new, r)
        done = done | (removed == 0) | (n_new <= 3)
        return valid, r, buf, done, rejl, rejh, knife, it + 1

    state = (valid0, jnp.zeros(p, jnp.int32), jnp.zeros((f, p), jnp.int8),
             jnp.zeros(p, bool), jnp.zeros(p, jnp.int32),
             jnp.zeros(p, jnp.int32), jnp.zeros(p, bool), jnp.int32(0))
    valid, r, buf, done, rejl, rejh, knife, _ = jax.lax.while_loop(
        cond, body, state)
    return valid, sv_orig, rejl, rejh, knife


@functools.partial(jax.jit, static_argnames=("plow", "phigh"))
def reject_percentile(vals: Array, plow: float, phigh: float):
    """PERCENTILE clipping (stacking.c:1130-1143, loop :1656-1673):
    single pass on relative deviation from the median; remove only if N>1."""
    f, p = vals.shape
    sv = sort_axis0(vals)
    valid = jnp.ones((f, p), dtype=bool)
    n = jnp.full((p,), f, jnp.int32)
    median = _gsl_median(sv, valid, n)
    medsafe = jnp.where(median == 0, 1e-30, median)
    low = ((median[None, :] - sv) / medsafe[None, :] > plow)
    high = ((sv - median[None, :]) / medsafe[None, :] > phigh)
    flags = low | high
    if f > 1:
        # removal scans ascending and stops at N == 1: if every element is
        # flagged, the last (largest) one survives (stacking.c:1667-1673)
        all_flagged = jnp.all(flags, axis=0)
        is_last = jax.lax.broadcasted_iota(jnp.int32, (f, p), 0) == (f - 1)
        valid = jnp.where(all_flagged[None, :], is_last, ~flags)
    rejl = jnp.sum(low, axis=0).astype(jnp.int32)
    rejh = jnp.sum(high, axis=0).astype(jnp.int32)
    return valid, sv, rejl, rejh


@jax.jit
def reject_none(vals: Array):
    f, p = vals.shape
    z = jnp.zeros(p, jnp.int32)
    return jnp.ones((f, p), dtype=bool), vals, z, z


# ------------------------------------------------- fast window formulation

@functools.partial(jax.jit,
                   static_argnames=("siglow", "sighigh", "presorted"))
def reject_sigma_window(vals: Array, siglow: float, sighigh: float,
                        presorted: bool = False):
    """SIGMA rejection, window formulation — the benchmark hot path.

    On the sorted pixel vector, sigma clipping always removes a PREFIX
    (low rejects) and a SUFFIX (high rejects), so the survivor set is a
    contiguous window [lo, hi). Tracking two (P,) counters replaces the
    per-iteration cumsum chains of the masked formulation with two
    take_along_axis gathers and ~3 fused elementwise passes.

    Statistics use the same exact-integer-sum construction as _gsl_sd and
    the mean is exact integer round-half-up, so on the NON-degenerate
    path this kernel agrees with the compiled reference bit-for-bit
    (tests/test_c_goldens.py).

    The one semantic gap: the reference's mid-scan break (N - r <= 4,
    stacking.c:1684-1688) plus its stale-buffer removals cannot be
    expressed as a contiguous window. Instead of approximating, any pixel
    whose scan WOULD hit the break (n - r - flags <= 4 at some pass) is
    flagged DEGENERATE and frozen; reject_and_mean re-runs exactly those
    pixels through the exact masked kernel.

    Returns (mean uint16 (P,), rejl, rejh, degenerate bool (P,)).
    """
    f, p = vals.shape
    sv = vals if presorted else sort_axis0(vals)
    iota = jax.lax.broadcasted_iota(jnp.int32, (f, p), 0)
    svi = sv.astype(jnp.int32)

    def win_stats(lo, hi):
        n = hi - lo
        nf = n.astype(jnp.float32)
        mask = (iota >= lo[None, :]) & (iota < hi[None, :])
        k1 = lo + (n - 1) // 2
        k2 = lo + n // 2
        v1 = jnp.take_along_axis(svi, k1[None, :], axis=0)[0]
        v2 = jnp.take_along_axis(svi, k2[None, :], axis=0)[0]
        median = 0.5 * (v1 + v2).astype(jnp.float32)
        # exact-integer sigma (see _gsl_sd): center on the low median
        d = jnp.where(mask, svi - v1[None, :], 0)
        s1 = jnp.sum(d, axis=0)
        ad = jnp.abs(d)
        hi8 = ad >> 8
        lo8 = ad & 255
        s2 = (jnp.sum(hi8 * hi8, axis=0).astype(jnp.float32) * 65536.0
              + jnp.sum(hi8 * lo8, axis=0).astype(jnp.float32) * 512.0
              + jnp.sum(lo8 * lo8, axis=0).astype(jnp.float32))
        s1f = s1.astype(jnp.float32)
        var = (s2 - s1f * s1f / jnp.maximum(nf, 1.0)) / jnp.maximum(nf - 1.0, 1.0)
        sigma = jnp.where(n > 1, sqrt_rn(jnp.maximum(var, 0.0)), 0.0)
        return n, mask, median, sigma

    def cond(state):
        _, _, _, done, _, _, _, it = state
        return (~jnp.all(done)) & (it < MAX_ITERS)

    def body(state):
        lo, hi, r, done, rejl, rejh, degen, it = state
        n, mask, median, sigma = win_stats(lo, hi)
        svf = sv.astype(jnp.float32)
        low = mask & (median[None, :] - svf > siglow * sigma[None, :])
        high = mask & (svf - median[None, :] > sighigh * sigma[None, :])
        nlow = jnp.sum(low, axis=0).astype(jnp.int32)
        nhigh = jnp.sum(high, axis=0).astype(jnp.int32)
        # the C scan breaks iff n - (r + c) <= 4 for some prefix count c
        # (max c = nlow + nhigh), incl. c == 0 when n - r <= 4 already
        hits_break = (n - r - (nlow + nhigh)) <= 4
        removed = nlow + nhigh
        upd = ~done & ~hits_break
        lo = jnp.where(upd, lo + nlow, lo)
        hi = jnp.where(upd, hi - nhigh, hi)
        rejl = rejl + jnp.where(upd, nlow, 0)
        rejh = rejh + jnp.where(upd, nhigh, 0)
        r = jnp.where(upd, r + removed, r)
        degen = degen | (~done & hits_break)
        done = done | hits_break | (removed == 0) | ((hi - lo) <= 3)
        return lo, hi, r, done, rejl, rejh, degen, it + 1

    z = jnp.zeros(p, jnp.int32)
    state = (z, jnp.full((p,), f, jnp.int32), z, jnp.zeros(p, bool), z, z,
             jnp.zeros(p, bool), jnp.int32(0))
    lo, hi, r, done, rejl, rejh, degen, _ = jax.lax.while_loop(
        cond, body, state)
    # exact integer mean of the surviving window
    mask = (iota >= lo[None, :]) & (iota < hi[None, :])
    n = hi - lo
    s = jnp.sum(jnp.where(mask, svi, 0), axis=0)
    mean = jnp.clip(jnp.where(n > 0, (2 * s + n) // jnp.maximum(2 * n, 1), 0),
                    0, 65535).astype(jnp.uint16)
    return mean, rejl, rejh, degen


_ALGOS = {
    "sigma": reject_sigma,
    "sigmedian": reject_sigmedian,
    "winsorized": reject_winsorized,
    "linearfit": reject_linearfit,
    "percentile": reject_percentile,
}


def reject_and_mean(vals: Array, rejection: str, sig=(3.0, 3.0),
                    fused: bool = True):
    """Full rejection + mean for a (F, P) block of normalized pixel values
    (always WORD-valued: the reference rounds to WORD before rejection,
    stacking.c:1635-1651).

    Returns (uint16 mean (P,), rejlow (P,), rejhigh (P,)).

    Where :func:`~siriltpu.ops.pallas.reject_stack.fused_applies` holds,
    a program compiled for an NVIDIA GPU runs the fused kernel
    (bit-exact, counters included); every other program, and every call
    with ``fused=False``, runs the plain XLA path below.

    ``sigma`` is a HYBRID: the fast window kernel handles every pixel on
    the normal path (bit-exact vs the compiled C), and the rare pixels
    that hit the reference's degenerate mid-scan-break path (N - r <= 4,
    whose stale-buffer removals aren't window-shaped) are re-run through
    the reference-exact masked kernel. ``sigma_masked`` forces the masked
    loop for everything.
    """
    if fused and rejection == "sigma" and fused_applies(rejection,
                                                        vals.shape[0]):
        return jax.lax.platform_dependent(
            vals,
            cuda=lambda v: fused_stack(_as_word(v), rejection,
                                       float(sig[0]), float(sig[1])),
            default=lambda v: _reject_and_mean_plain(v, rejection, sig))
    return _reject_and_mean_plain(vals, rejection, sig)


def _as_word(vals: Array) -> Array:
    return (vals if vals.dtype == jnp.uint16
            else jnp.clip(vals, 0, 65535).astype(jnp.uint16))


def _reject_and_mean_plain(vals: Array, rejection: str, sig):
    if rejection == "sigma":
        # sort ONCE in the input dtype (uint16 halves sort bandwidth),
        # run the fast window kernel, then the exact masked kernel with
        # active=degen: when no pixel is degenerate its while_loop exits
        # before the first pass, so the fallback costs ~nothing. Fully
        # jit-compatible (no host branch).
        sv = sort_axis0(vals)
        mean, rejl, rejh, degen = reject_sigma_window(
            sv, float(sig[0]), float(sig[1]), presorted=True)
        valid, v, srl, srh = reject_sigma(
            sv.astype(jnp.float32), float(sig[0]), float(sig[1]),
            active=degen, presorted=True)
        smean = _mean_of_survivors(v, valid)
        mean = jnp.where(degen, smean, mean)
        rejl = jnp.where(degen, srl, rejl)
        rejh = jnp.where(degen, srh, rejh)
        return mean, rejl, rejh
    if not jnp.issubdtype(vals.dtype, jnp.floating):
        vals = vals.astype(jnp.float32)
    if rejection in ("none", None):
        valid, v, rejl, rejh = reject_none(vals)
    elif rejection == "sigma_masked":
        valid, v, rejl, rejh = reject_sigma(vals, float(sig[0]), float(sig[1]))
    elif rejection == "linearfit":
        valid, v, rejl, rejh, _knife = reject_linearfit(
            vals, float(sig[0]), float(sig[1]))
    else:
        valid, v, rejl, rejh = _ALGOS[rejection](vals, float(sig[0]), float(sig[1]))
    return _mean_of_survivors(v, valid), rejl, rejh


def linearfit_hybrid_block(flat, sig=(3.0, 3.0)):
    """LINEARFIT hybrid, host level (the linearfit analog of sigma's
    hybrid): the f32 device kernel decides every pixel, and the rare
    pixels whose residual/sigma ratio came within LINEARFIT_KNIFE_EPS
    of the clip threshold — where f32 can flip the C's f64 decision,
    PARITY.md 7a — are re-run through the literal f64 oracle
    (verify/oracle.c_reject_block, stacking.c:1750-1783 semantics).

    ``flat``: (F, P) WORD-valued array. Returns numpy
    ``(mean uint16 (P,), rejlow (P,), rejhigh (P,))``, bit-exact vs the
    compiled C including counters.
    """
    import numpy as np

    flat_np = np.asarray(flat)
    valid, v, rejl, rejh, knife = reject_linearfit(
        jnp.asarray(flat_np, jnp.float32), float(sig[0]), float(sig[1]))
    mean = np.asarray(_mean_of_survivors(v, valid)).copy()
    rejl = np.asarray(rejl).copy()
    rejh = np.asarray(rejh).copy()
    kidx = np.nonzero(np.asarray(knife))[0]
    if kidx.size:
        from siriltpu.utils.rounding import np_round_to_word
        from siriltpu.verify.oracle import c_reject_block
        for pidx in kidx:
            surv, crej = c_reject_block(
                flat_np[:, pidx].astype(np.uint16), "linearfit", sig)
            mean[pidx] = (np_round_to_word(
                surv.astype(np.float64).sum() / surv.size)
                if surv.size else 0)
            rejl[pidx] = crej[0]
            rejh[pidx] = crej[1]
    return mean, rejl, rejh


def masked_median(vals: Array, fused: bool = True) -> Array:
    """Median stack pixel op (stacking.c:765-767): GSL sorted median,
    C-truncated to WORD on assignment. Inputs are always WORD-valued
    (raw uint16 or round_to_word-normalized floats), so a program
    compiled for an NVIDIA GPU runs the fused kernel in uint16
    (one read of the block); elsewhere, or with ``fused=False``, the
    plain network sort below."""
    f, p = vals.shape
    if fused and fused_applies("median", f):
        return jax.lax.platform_dependent(
            vals,
            cuda=lambda v: fused_stack(_as_word(v), "median")[0],
            default=_masked_median_plain)
    return _masked_median_plain(vals)


def _masked_median_plain(vals: Array) -> Array:
    f, p = vals.shape
    sv = sort_axis0(vals)
    valid = jnp.ones((f, p), dtype=bool)
    n = jnp.full((p,), f, jnp.int32)
    med = _gsl_median(sv, valid, n)
    return med.astype(jnp.uint16)  # C truncation


__all__ = ["reject_and_mean", "masked_median", "reject_sigma",
           "reject_sigmedian", "reject_winsorized", "reject_linearfit",
           "reject_percentile", "linearfit_hybrid_block",
           "LINEARFIT_KNIFE_EPS", "MAX_ITERS"]
