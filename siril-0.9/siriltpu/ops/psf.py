"""Elliptical-Gaussian PSF fitting with Levenberg–Marquardt, batched over
stars with ``vmap``.

Reference: src/algos/PSF.c.

Model (no angle, :160-187): f(i,j) = B + A·exp(−((tx−x0)²/SX + (ty−y0)²/SY))
with tx = j+1, ty = i+1 over the box (1-based grid).
Model (angle, :230-309): coordinates rotated about (x0, y0) by alpha.

Initialization (``psf_init_data`` :92-139): find the max after 3×3
neighbor-median hot-pixel suppression (:47-89), then walk out along the
max row/column while pixel−bg > (max−bg)/2; x0,y0 = midpoints (+1), and
SX, SY = trunc(extent²/(4 ln 2)).

Fit: GSL lmsder, at most 10 iterations (:40-41), delta test 1e-4/1e-4.
We implement classical Levenberg-Marquardt with the same analytic
Jacobians (:189-220, :262-301), same iteration cap and the same
gsl_multifit_test_delta stopping rule — numerically equivalent within
the acceptance tolerances of ``is_star`` (star_finder.c:59-78), not
bit-identical to GSL's trust-region internals.

Post-processing (``psf_global_minimisation`` :620-662): optional angle
refit when |sx−sy| ≥ 0.01, symmetry fix to sx ≥ sy with ±90° angle fold,
B/A/RMSE normalized by the image norm value, FWHM = sqrt(S/2)·2·sqrt(2 ln 2),
magnitude = −2.5·log10(Σ(z−B)) (:145-155).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

MAX_ITER = 10     # PSF.c:40-41
EPSILON_ANGLE = 0.01
_FWHM_K = 2.0 * np.sqrt(np.log(2.0) * 2.0)


class PSFFit(NamedTuple):
    """Fitted parameters, one per star (all (N,) arrays)."""
    B: Array
    A: Array
    x0: Array
    y0: Array
    sx: Array
    sy: Array
    angle: Array
    fwhmx: Array
    fwhmy: Array
    rmse: Array
    mag: Array
    ok: Array  # n > p and finite results


# ------------------------------------------------------------------- init

def _median3x3_neighbors(z: Array) -> Array:
    """3×3 neighbor median (center excluded) used for hot-pixel
    suppression before locating the max (PSF.c:47-89). Interior pixels
    take the GSL median of their 8 neighbors; the reference's border
    handling reads one stray zero into the window (start = 8-n-1), which
    we reproduce by zero-padding and keeping window size 9−1."""
    h, w = z.shape
    p = jnp.pad(z, 1, constant_values=0.0)
    taps = []
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            taps.append(p[dy : dy + h, dx : dx + w])
    stack = jnp.stack(taps)                      # (8, h, w)
    s = jnp.sort(stack, axis=0)
    # interior: median of 8 = mean of 4th/5th order stats.
    # (the reference reads out of bounds here — UB; we use the sane median)
    return 0.5 * (s[3] + s[4])


def _init_params(z: Array, bg: Array) -> Tuple[Array, ...]:
    """psf_init_data (PSF.c:92-139)."""
    h, w = z.shape
    filt = _median3x3_neighbors(z)
    idx = jnp.argmax(filt)
    iy = idx // w
    ix = idx % w
    peak = z[iy, ix]
    half = (peak - bg)

    # walk-outs: find the furthest index where 2*(z - bg) > (peak - bg)
    # while walking from the peak (monotone emulation via masked scans)
    col = z[:, ix] - bg
    row = z[iy, :] - bg
    ii = jnp.arange(h)
    jj = jnp.arange(w)

    def walk(values, center, n):
        # down/up walk: the reference advances while the NEXT value still
        # satisfies 2*v > half; equivalently the first failing index.
        cond = 2.0 * values > half
        # upward (increasing index): first index > center where cond fails
        after = jnp.where((jnp.arange(n) > center) & ~cond, jnp.arange(n), n)
        stop_hi = jnp.min(after)
        hi = jnp.minimum(stop_hi, n - 1)
        hi = jnp.where(stop_hi <= n - 1, stop_hi, n - 1)
        # downward
        before = jnp.where((jnp.arange(n) < center) & ~cond, jnp.arange(n), -1)
        stop_lo = jnp.max(before)
        lo = jnp.maximum(stop_lo, 0)
        return lo, hi

    # NOTE on semantics: the C loop `while (2*(z[ii1]) > half && ii1 < N-1) ii1++`
    # stops AT the first failing index (or N-1). walk() returns exactly that.
    ii2, ii1 = walk(col, iy, h)
    jj2, jj1 = walk(row, jx := ix, w)
    x0 = (jj1 + jj2 + 2) / 2.0
    y0 = (ii1 + ii2 + 2) / 2.0
    ln2 = jnp.log(2.0)
    sy0 = jnp.floor((ii1 - ii2) ** 2 / 4.0 / ln2)   # (size_t) cast truncates
    sx0 = jnp.floor((jj1 - jj2) ** 2 / 4.0 / ln2)
    sx0 = jnp.maximum(sx0, 1.0)
    sy0 = jnp.maximum(sy0, 1.0)
    return (bg, peak, x0, y0, sx0, sy0)


# ----------------------------------------------------------------- residual

def _model_no_angle(params, tx, ty):
    B, A, x0, y0, sx, sy = params
    e = jnp.exp(-(((tx - x0) ** 2) / sx + ((ty - y0) ** 2) / sy))
    return B + A * e, e


def _resid_jac_no_angle(params, tx, ty, y):
    B, A, x0, y0, sx, sy = params
    f, e = _model_no_angle(params, tx, ty)
    r = f - y
    J = jnp.stack([
        jnp.ones_like(e),
        e,
        A * e * 2.0 * (tx - x0) / sx,
        A * e * 2.0 * (ty - y0) / sy,
        A * e * (tx - x0) ** 2 / sx ** 2,
        A * e * (ty - y0) ** 2 / sy ** 2,
    ], axis=-1)
    return r, J


def _model_angle(params, tx0, ty0):
    B, A, x0, y0, sx, sy, al = params
    ca, sa = jnp.cos(al), jnp.sin(al)
    tx = ca * (tx0 - x0) - sa * (ty0 - y0) + x0
    ty = sa * (tx0 - x0) + ca * (ty0 - y0) + y0
    e = jnp.exp(-(((tx - x0) ** 2) / sx + ((ty - y0) ** 2) / sy))
    return B + A * e, e, tx, ty


def _resid_jac_angle(params, tx0, ty0, y):
    B, A, x0, y0, sx, sy, al = params
    f, e, tx, ty = _model_angle(params, tx0, ty0)
    ca, sa = jnp.cos(al), jnp.sin(al)
    r = f - y
    dxr = -sa * (tx0 - x0) - ca * (ty0 - y0)
    dyr = ca * (tx0 - x0) - sa * (ty0 - y0)
    J = jnp.stack([
        jnp.ones_like(e),
        e,
        A * e * 2.0 * (tx - x0) / sx * ca,
        A * e * 2.0 * (ty - y0) / sy * ca,
        A * e * (tx - x0) ** 2 / sx ** 2,
        A * e * (ty - y0) ** 2 / sy ** 2,
        -A * e * (2.0 * (tx - x0) / sx * dxr + 2.0 * (ty - y0) / sy * dyr),
    ], axis=-1)
    return r, J


def _lm_fit(resid_jac, params0: Array, args, max_iter: int = MAX_ITER):
    """Classical LM with diagonal damping and the GSL delta test."""
    nparams = params0.shape[0]

    def cost_of(p):
        r, _ = resid_jac(tuple(p), *args)
        return jnp.sum(r * r)

    def body(state):
        p, lam, it, done = state
        r, J = resid_jac(tuple(p), *args)
        # precision='highest': a float32 matmul may otherwise run in
        # TF32 on a GPU, which would perturb the normal equations of the
        # LM fit; these are tiny (npix x 7) products, full f32 is free
        Jm = J.reshape(-1, nparams)
        g = jnp.matmul(Jm.T, r.reshape(-1), precision="highest")
        H = jnp.matmul(Jm.T, Jm, precision="highest")
        D = jnp.diag(jnp.maximum(jnp.diag(H), 1e-12))
        step = jnp.linalg.solve(H + lam * D, -g)
        newp = p + step
        old_cost = jnp.sum(r * r)
        new_cost = cost_of(newp)
        improved = (new_cost < old_cost) & jnp.all(jnp.isfinite(newp))
        p_next = jnp.where(improved, newp, p)
        lam_next = jnp.where(improved, lam * 0.3, lam * 10.0)
        # gsl_multifit_test_delta(dx, x, 1e-4, 1e-4)
        converged = improved & jnp.all(
            jnp.abs(step) < 1e-4 + 1e-4 * jnp.abs(newp))
        return p_next, lam_next, it + 1, done | converged

    def cond(state):
        _, _, it, done = state
        return (it < max_iter) & ~done

    # anchor the literal carries to the input data: under shard_map a
    # plain-constant carry is "unvarying" over the mesh axis while the
    # body's data-dependent update is "varying", which while_loop
    # rejects (scan-vma). Adding a data-derived zero keeps the value
    # and inherits the right varyingness in both contexts.
    vzero = params0.reshape(-1)[0] * 0
    state = (params0, jnp.float32(1e-3) + vzero, jnp.int32(0), vzero > 0)
    p, _, _, _ = jax.lax.while_loop(cond, body, state)
    r, _ = resid_jac(tuple(p), *args)
    return p, jnp.sqrt(jnp.mean(r * r))


# ------------------------------------------------------------------ driver

def _fit_one(z: Array, bg: Array, fit_angle: bool):
    """Fit one (h, w) box. Returns the 7-tuple + rmse."""
    h, w = z.shape
    ty, tx = jnp.mgrid[1 : h + 1, 1 : w + 1].astype(jnp.float32)
    y = z.astype(jnp.float32)
    B0, A0, x00, y00, sx0, sy0 = _init_params(y, bg)
    p0 = jnp.stack([B0, A0 , x00, y00, sx0, sy0]).astype(jnp.float32)
    p, rmse = _lm_fit(_resid_jac_no_angle, p0, (tx, ty, y))
    B, A, x0, y0, sx, sy = p
    angle = jnp.float32(0.0)
    if fit_angle:
        def do_angle(_):
            pa0 = jnp.concatenate([p, jnp.zeros((1,), p.dtype)])
            pa, rmse_a = _lm_fit(_resid_jac_angle, pa0, (tx, ty, y))
            return pa, rmse_a

        def no_angle(_):
            return jnp.concatenate([p, jnp.zeros((1,), p.dtype)]), rmse

        pa, rmse2 = jax.lax.cond(jnp.abs(sx - sy) >= EPSILON_ANGLE,
                                 do_angle, no_angle, None)
        B, A, x0, y0, sx, sy, alpha = pa
        rmse = rmse2
        # angle in degrees, folded into [-90, 90] (PSF.c:512-523)
        angle = -alpha * (180.0 / jnp.pi)

        def fold(a):
            return jax.lax.while_loop(
                lambda v: jnp.abs(v) > 90.0,
                lambda v: jnp.where(v > 0.0, v - 90.0, v + 90.0), a)

        angle = fold(angle)
    # symmetry fix: sx >= sy, angle folding (PSF.c:636-644)
    swap = sy > sx
    sx, sy = jnp.where(swap, sy, sx), jnp.where(swap, sx, sy)
    angle = jnp.where(swap & (angle != 0.0),
                      jnp.where(angle > 0.0, angle - 90.0, angle + 90.0),
                      angle)
    mag = -2.5 * jnp.log10(jnp.maximum(jnp.sum(y - B), 1e-30))
    return B, A, x0, y0, sx, sy, angle, rmse, mag


@functools.partial(jax.jit, static_argnames=("fit_angle",))
def fit_psf_batch(boxes: Array, bgs: Array, fit_angle: bool = False,
                  norm: float = 65535.0) -> PSFFit:
    """Fit a batch of star boxes (N, h, w) with backgrounds (N,).

    Returns a PSFFit of (N,) arrays; B/A/rmse normalized by ``norm``
    (psf_global_minimisation :647-650)."""
    n, h, w = boxes.shape
    out = jax.vmap(lambda z, b: _fit_one(z, b, fit_angle))(
        boxes.astype(jnp.float32), bgs.astype(jnp.float32))
    B, A, x0, y0, sx, sy, angle, rmse, mag = out
    fwhmx = jnp.sqrt(sx / 2.0) * _FWHM_K
    fwhmy = jnp.sqrt(sy / 2.0) * _FWHM_K
    ok = (h * w > (7 if fit_angle else 6))
    okv = (jnp.isfinite(fwhmx) & jnp.isfinite(fwhmy) &
           (fwhmx > 0) & (fwhmy > 0) & ok)
    return PSFFit(B=B / norm, A=A / norm, x0=x0, y0=y0, sx=sx, sy=sy,
                  angle=angle, fwhmx=fwhmx, fwhmy=fwhmy, rmse=rmse / norm,
                  mag=mag, ok=okv)


def fit_psf_single(z: np.ndarray, bg: float, *, fit_angle: bool = True,
                   norm: float = 65535.0) -> Optional[dict]:
    """One-box convenience wrapper (psf_global_minimisation semantics).
    Returns a dict or None if the fit is invalid."""
    z = np.asarray(z, dtype=np.float32)
    if z.size <= (7 if fit_angle else 6):
        return None
    r = fit_psf_batch(jnp.asarray(z)[None], jnp.asarray([bg], jnp.float32),
                      fit_angle=fit_angle, norm=norm)
    if not bool(np.asarray(r.ok[0])):
        return None
    return {k: float(np.asarray(getattr(r, k)[0])) for k in
            ("B", "A", "x0", "y0", "sx", "sy", "angle", "fwhmx", "fwhmy",
             "rmse", "mag")}


__all__ = ["fit_psf_batch", "fit_psf_single", "PSFFit", "MAX_ITER"]
