"""Perspective / affine image warping with OpenCV-compatible
interpolation kernels — the geometric engine of global star alignment.

Reference: ``cvTransformImage`` (src/opencv/opencv.cpp:242-309) =
``warpPerspective(in, out, H, size, interpolation)`` applied to the
top-down-flipped image (registration.c:720-722 flips, warps, flips back
because the rotation center is at (0,0) in the star coordinate frame).

Semantics: dst(x, y) = src(H^{-1} · (x, y, 1)), constant-0 border.
Interpolations: nearest, linear (bilinear), cubic (Keys, A = -0.75),
lanczos4 (normalized sinc(d)·sinc(d/4), 8-tap — verified weight-exact
vs OpenCV 4.6, tests/goldens/c_cvgeom.bin); OpenCV's warpPerspective/
warpAffine remap INTER_AREA to linear. OpenCV quantizes warp sample
coordinates to 1/32 px (INTER_BITS); we compute in float32 (strictly
more accurate; the golden test emulates the quantization to prove the
kernels match bit-for-bit, see tests/test_cv_goldens.py).

Device-native: the warp is a fused gather — coordinate grids + k×k weighted
taps, vmapped over channels/frames; no scalar loops.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

# Interpolation values are API surface: the reference passes its
# config/GUI integer VERBATIM into cv::resize / warpAffine /
# warpPerspective (opencv.cpp:89,153,262), so at runtime the values
# mean what OpenCV's real InterpolationFlags enum says they mean:
#   0 nearest, 1 linear, 2 CUBIC, 3 AREA, 4 lanczos4.
# The reference's own enum NAMES (siril.h:257-264 "OPENCV_AREA = 2,
# OPENCV_CUBIC = 3") are swapped relative to OpenCV and therefore lie:
# a Siril 0.9 user selecting the GUI item wired to value 2 ("Area")
# actually gets bicubic, and value 3 ("Cubic") actually gets
# area-resample in resize / bilinear in warps. We reproduce the
# OBSERVABLE behavior (what the linked OpenCV executes), not the
# header's mislabels — see PARITY.md "interpolation enum" and the
# real-OpenCV golden suite (tests/goldens/c_cvgeom.bin).
INTER_NEAREST = 0   # cv::INTER_NEAREST
INTER_LINEAR = 1    # cv::INTER_LINEAR
INTER_CUBIC = 2     # cv::INTER_CUBIC   (siril.h mislabels 2 "OPENCV_AREA")
INTER_AREA = 3      # cv::INTER_AREA    (siril.h mislabels 3 "OPENCV_CUBIC")
INTER_LANCZOS4 = 4  # cv::INTER_LANCZOS4

_CUBIC_A = -0.75


def _cubic_weights(t: Array):
    """OpenCV interpolateCubic with A = -0.75; t in [0,1)."""
    A = _CUBIC_A
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    u = 1.0 - t
    w2 = ((A + 2) * u - (A + 3)) * u * u + 1
    w3 = 1.0 - w0 - w1 - w2
    return [w0, w1, w2, w3]


def _lanczos4_weights(t: Array):
    """Normalized Lanczos-4 windowed sinc, sinc(d)·sinc(d/4) over taps
    at distances d = t+3-i, i = 0..7 — OpenCV interpolateLanczos4's
    kernel, verified weight-exact against the real cv::resize /
    warpPerspective (c_cvgeom goldens; e.g. t=0.25 tap weights
    0.893389/-0.152304/... match to float precision)."""
    ws = []
    total = 0.0
    for i in range(8):
        d = t + (3 - i)
        x = jnp.where(jnp.abs(d) < 1e-7, 1e-7, d) * np.pi
        w = (jnp.sin(x) / x) * (jnp.sin(x * 0.25) / (x * 0.25))
        ws.append(w)
        total = total + w
    ws = [w / total for w in ws]
    # exact-integer coordinate: delta function on tap 3
    exact = t < 1e-7
    out = []
    for i, w in enumerate(ws):
        out.append(jnp.where(exact, 1.0 if i == 3 else 0.0, w))
    return out


def _tap(img: Array, yi: Array, xi: Array) -> Array:
    h, w = img.shape
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    yc = jnp.clip(yi, 0, h - 1)
    xc = jnp.clip(xi, 0, w - 1)
    # flat linear-index gather rather than a 2-D gather
    return jnp.where(inb, img.reshape(-1)[yc * w + xc], 0.0)


def _interp(img: Array, xs: Array, ys: Array, interpolation: int) -> Array:
    if interpolation == INTER_AREA:
        # cv::warpPerspective / warpAffine have no AREA path and fall
        # back to INTER_LINEAR (OpenCV remap semantics); same here so a
        # migrated cfg value 2 registers instead of crashing.
        interpolation = INTER_LINEAR
    if interpolation == INTER_NEAREST:
        xi = jnp.floor(xs + 0.5).astype(jnp.int32)
        yi = jnp.floor(ys + 0.5).astype(jnp.int32)
        return _tap(img, yi, xi)
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx = (xs - x0).astype(img.dtype)
    fy = (ys - y0).astype(img.dtype)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    if interpolation == INTER_LINEAR:
        wx = [1.0 - fx, fx]
        wy = [1.0 - fy, fy]
        offs = (0, 1)
        base = 0
    elif interpolation == INTER_CUBIC:
        wx = _cubic_weights(fx)
        wy = _cubic_weights(fy)
        offs = (0, 1, 2, 3)
        base = -1
    elif interpolation == INTER_LANCZOS4:
        wx = _lanczos4_weights(fx)
        wy = _lanczos4_weights(fy)
        offs = tuple(range(8))
        base = -3
    else:
        raise ValueError(f"unknown interpolation {interpolation}")
    out = jnp.zeros_like(fx)
    for dy in offs:
        row = jnp.zeros_like(fx)
        for dx in offs:
            row = row + wx[dx] * _tap(img, y0i + base + dy, x0i + base + dx)
        out = out + wy[dy] * row
    return out


@functools.partial(jax.jit, static_argnames=("out_shape", "interpolation"))
def warp_perspective(img: Array, H_inv: Array,
                     out_shape: Tuple[int, int],
                     interpolation: int = INTER_LINEAR) -> Array:
    """dst(x,y) = img(H_inv @ (x,y,1)), constant-0 border, float in/out."""
    oh, ow = out_shape
    yy = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 1)
    w = H_inv[2, 0] * xx + H_inv[2, 1] * yy + H_inv[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    xs = (H_inv[0, 0] * xx + H_inv[0, 1] * yy + H_inv[0, 2]) / w
    ys = (H_inv[1, 0] * xx + H_inv[1, 1] * yy + H_inv[1, 2]) / w
    return _interp(img.astype(jnp.float32), xs, ys, interpolation)


# -------------------------------------------------- tiled banded warp
#
# The tap-by-tap gather warp above reads every tap through a per-pixel
# 2-D gather. Registration homographies are
# near-identity, so the warp has LOCALITY: the preimage of an output
# tile is a tile-sized source window, and within the tile the source
# coordinate offset varies by only a few pixels. That turns the warp
# into dense arithmetic: slice the window once per tile, then
#
#   out(yr, xr) = sum_{k<Ky} sum_{j<Kx}
#       kernel(dy - k) * kernel(dx - j) * window[yr + k, xr + j]
#
# where dy = (src_y - window_origin_y) - yr lies in [0, Ky) by
# construction — every term is a STATIC shifted view and an elementwise
# FMA, no gathers at all. Band sizes Ky/Kx are computed on
# the host from the homography (in-tile coordinate variation + kernel
# support) and are static; callers fall back to the gather path when
# the warp is too far from identity for a small band.

_TILE_H, _TILE_W = 256, 512
_BAND_CAP = 40          # fall back to the gather path beyond this
_SUPPORT = {INTER_NEAREST: (0, 1), INTER_LINEAR: (0, 2),
            INTER_AREA: (0, 2), INTER_CUBIC: (-1, 4),
            INTER_LANCZOS4: (-3, 8)}


def _kernel_eval(interpolation: int, d: Array) -> Array:
    """Interpolation kernel as a function of signed tap distance d —
    the same weights _cubic_weights/_lanczos4_weights produce tap-wise
    (lanczos is returned UNNORMALIZED; callers divide by the per-axis
    weight sum, which equals the 8-tap normalizer)."""
    if interpolation == INTER_NEAREST:
        # floor(x + 0.5) = k  <=>  d = x - k in [-0.5, 0.5)
        return ((d >= -0.5) & (d < 0.5)).astype(jnp.float32)
    if interpolation in (INTER_LINEAR, INTER_AREA):
        return jnp.maximum(0.0, 1.0 - jnp.abs(d))
    if interpolation == INTER_CUBIC:
        A = _CUBIC_A
        a = jnp.abs(d)
        near = ((A + 2) * a - (A + 3)) * a * a + 1
        far = ((A * a - 5 * A) * a + 8 * A) * a - 4 * A
        return jnp.where(a <= 1.0, near,
                         jnp.where(a < 2.0, far, 0.0))
    if interpolation == INTER_LANCZOS4:
        a = jnp.abs(d)
        x = jnp.where(a < 1e-7, 1e-7, d) * np.pi
        w = (jnp.sin(x) / x) * (jnp.sin(x * 0.25) / (x * 0.25))
        w = jnp.where(a < 1e-7, 1.0, w)
        return jnp.where(a < 4.0, w, 0.0)
    raise ValueError(f"unknown interpolation {interpolation}")


@functools.partial(jax.jit, static_argnames=(
    "out_shape", "interpolation", "band_y", "band_x", "pad"))
def _warp_perspective_tiled(img: Array, H_inv: Array,
                            out_shape: Tuple[int, int],
                            interpolation: int,
                            band_y: int, band_x: int, pad: int) -> Array:
    oh, ow = out_shape
    nty = -(-oh // _TILE_H)
    ntx = -(-ow // _TILE_W)
    src = jnp.pad(img.astype(jnp.float32),
                  ((pad, pad + band_y), (pad, pad + band_x)))
    sh, sw = src.shape
    tap_lo, _ = _SUPPORT[INTER_LINEAR if interpolation == INTER_AREA
                         else interpolation]
    normalize = interpolation == INTER_LANCZOS4

    yr = jax.lax.broadcasted_iota(jnp.float32, (_TILE_H, _TILE_W), 0)
    xr = jax.lax.broadcasted_iota(jnp.float32, (_TILE_H, _TILE_W), 1)

    if interpolation == INTER_LANCZOS4:
        # Lanczos tap weights via the shift identity: for integer k,
        #   sin(π(d−k))   = (−1)^k · sin(πd)
        #   sin(π(d−k)/4) = sin(πd/4)cos(πk/4) − cos(πd/4)sin(πk/4)
        # so the WHOLE band needs three transcendentals of d per axis
        # (precomputed once per tile) instead of two sins per tap —
        # the taps reduce to a handful of FMAs each. Same math as
        # _kernel_eval to within f32 argument-reduction rounding.
        PI = np.float32(np.pi)

        def l4_trig(d):
            return (jnp.sin(PI * d), jnp.sin(PI * d / 4),
                    jnp.cos(PI * d / 4))

        def l4_weight(trig, d, kf):
            sd, s4, c4 = trig
            sign = 1.0 - 2.0 * jnp.abs(kf % 2.0)       # (−1)^k
            c4k = jnp.cos(PI * kf / 4.0)               # scalar trig
            s4k = jnp.sin(PI * kf / 4.0)
            dk = d - kf
            den = (PI * PI / 4.0) * dk * dk
            w = (sign * sd * (s4 * c4k - c4 * s4k)
                 / jnp.where(jnp.abs(dk) < 1e-7, 1.0, den))
            w = jnp.where(jnp.abs(dk) < 1e-7, 1.0, w)
            return jnp.where(jnp.abs(dk) < 4.0, w, 0.0)

    def one_tile(tidx):
        ty = tidx // ntx
        tx = tidx % ntx
        toy = (ty * _TILE_H).astype(jnp.float32)
        tox = (tx * _TILE_W).astype(jnp.float32)
        yy = yr + toy
        xx = xr + tox
        w = H_inv[2, 0] * xx + H_inv[2, 1] * yy + H_inv[2, 2]
        w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
        xs = (H_inv[0, 0] * xx + H_inv[0, 1] * yy + H_inv[0, 2]) / w
        ys = (H_inv[1, 0] * xx + H_inv[1, 1] * yy + H_inv[1, 2]) / w
        # window origin: floor of the min corner preimage + kernel base.
        # The preimage of the tile rectangle is a quadrilateral, so the
        # extremes live at the corners.
        woy = jnp.floor(jnp.min(ys - yr)) + tap_lo
        wox = jnp.floor(jnp.min(xs - xr)) + tap_lo
        oy = jnp.clip(woy.astype(jnp.int32) + pad, 0,
                      sh - (_TILE_H + band_y))
        ox = jnp.clip(wox.astype(jnp.int32) + pad, 0,
                      sw - (_TILE_W + band_x))
        window = jax.lax.dynamic_slice(
            src, (oy, ox), (_TILE_H + band_y, _TILE_W + band_x))
        dy = ys - (oy - pad).astype(jnp.float32) - yr   # in [0, band_y)
        dx = xs - (ox - pad).astype(jnp.float32) - xr   # in [0, band_x)
        if interpolation == INTER_LANCZOS4:
            trig_y = l4_trig(dy)
            trig_x = l4_trig(dx)

        def col_pass(k, acc):
            kf = k.astype(jnp.float32)
            if interpolation == INTER_LANCZOS4:
                wy = l4_weight(trig_y, dy, kf)
            else:
                wy = _kernel_eval(interpolation, dy - kf)
            rowwin = jax.lax.dynamic_slice(
                window, (k, 0), (_TILE_H, _TILE_W + band_x))

            def tap_x(j, inner):
                num, den = inner
                jf = j.astype(jnp.float32)
                if interpolation == INTER_LANCZOS4:
                    wx = l4_weight(trig_x, dx, jf)
                else:
                    wx = _kernel_eval(interpolation, dx - jf)
                v = jax.lax.dynamic_slice(rowwin, (0, j),
                                          (_TILE_H, _TILE_W))
                return (num + wy * wx * v, den + wy * wx)

            return jax.lax.fori_loop(0, band_x, tap_x, acc)

        # derive the accumulator from the (possibly shard_map-varying)
        # data so the fori_loop carry has matching vma types under a
        # frames mesh
        zero = window[:_TILE_H, :_TILE_W] * 0.0
        num, den = jax.lax.fori_loop(0, band_y, col_pass, (zero, zero))
        if normalize:
            num = num / jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
        return num

    tiles = jax.lax.map(one_tile, jnp.arange(nty * ntx))
    out = tiles.reshape(nty, ntx, _TILE_H, _TILE_W)
    out = out.transpose(0, 2, 1, 3).reshape(nty * _TILE_H, ntx * _TILE_W)
    return out[:oh, :ow]


_PLAN_STEP = 32    # fine-grid pitch for band planning; divides both tile dims
_PLAN_MARGIN = 2.0  # headroom for sub-grid displacement curvature


def _tiled_plan(Hinvs: np.ndarray, out_shape, in_shape, interpolation):
    """Host-side feasibility + static band sizes for the tiled warp.
    Returns (band_y, band_x, pad) or None when the warp moves too far
    from identity for a small band (gather fallback)."""
    if interpolation not in _SUPPORT:
        return None
    tap_lo, support = _SUPPORT[INTER_LINEAR if interpolation == INTER_AREA
                               else interpolation]
    oh, ow = out_shape
    h, w = in_shape
    Hinvs = np.asarray(Hinvs, np.float64).reshape(-1, 3, 3)
    nty = -(-oh // _TILE_H)
    ntx = -(-ow // _TILE_W)
    # preimage coords on a FINE grid (step 32), all frames at once. The
    # displacement field (sx - x, sy - y) of a projective map is NOT
    # linear over a tile — its extremes can sit in the tile interior,
    # so corner-only sampling can undersize the band and silently drop
    # kernel taps. Sample every _PLAN_STEP px (the grid lands exactly
    # on tile boundaries) and add _PLAN_MARGIN for sub-grid curvature;
    # SIRILTPU_CHECK_WARP_BAND=1 verifies the bound exactly per-pixel.
    gy = np.arange(0, nty * _TILE_H + _PLAN_STEP, _PLAN_STEP,
                   dtype=np.float64)
    gx = np.arange(0, ntx * _TILE_W + _PLAN_STEP, _PLAN_STEP,
                   dtype=np.float64)
    yy, xx = np.meshgrid(gy, gx, indexing="ij")
    ones = np.ones_like(yy)
    pts = np.stack([xx, yy, ones])                     # (3, Gy, Gx)
    prj = np.einsum("fab,bij->faij", Hinvs, pts)       # (F, 3, Gy, Gx)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = prj[:, 0] / prj[:, 2]
        sy = prj[:, 1] / prj[:, 2]
    if not (np.isfinite(sx).all() and np.isfinite(sy).all()):
        return None
    # per-tile source-coordinate variation beyond the tile's own extent:
    # max over tiles of (max displacement - min displacement) within the
    # tile's (inclusive) fine-grid window
    py = _TILE_H // _PLAN_STEP
    px = _TILE_W // _PLAN_STEP

    def band(sc, rel):
        d = sc - rel                                    # displacement field
        win = np.lib.stride_tricks.sliding_window_view(
            d, (py + 1, px + 1), axis=(1, 2))[:, ::py, ::px]
        hi = win.max(axis=(-2, -1))                     # (F, nty, ntx)
        lo = win.min(axis=(-2, -1))
        return float((hi - lo).max())
    vy = band(sy, yy) + _PLAN_MARGIN
    vx = band(sx, xx) + _PLAN_MARGIN
    band_y = int(np.ceil(vy)) + support + 1
    band_x = int(np.ceil(vx)) + support + 1
    # quantize to limit recompiles
    band_y = max(support + 2, -(-band_y // 4) * 4)
    band_x = max(support + 2, -(-band_x // 4) * 4)
    if band_y > _BAND_CAP or band_x > _BAND_CAP:
        return None
    # pad: window origins must stay inside the padded source
    disp = max(abs(float((sy - yy).min())), float((sy - yy).max()),
               abs(float((sx - xx).min())), float((sx - xx).max()))
    disp += _PLAN_MARGIN
    extent = max(oh + _TILE_H - h, ow + _TILE_W - w, 0)
    pad = int(np.ceil(disp)) + max(band_y, band_x) + extent + 8
    pad = -(-pad // 64) * 64
    if pad > 8192:
        return None
    if os.environ.get("SIRILTPU_CHECK_WARP_BAND"):
        _verify_band_exact(Hinvs, (nty, ntx), band_y, band_x, support)
    return band_y, band_x, pad


def _verify_band_exact(Hinvs, ntiles, band_y, band_x, support):
    """Debug-mode exact check (SIRILTPU_CHECK_WARP_BAND=1): evaluate the
    displacement field at EVERY output pixel and assert the planned band
    covers each tile's true in-tile variation — the guarantee the tiled
    kernel's static fori_loop tap range relies on."""
    nty, ntx = ntiles
    yy = np.arange(nty * _TILE_H, dtype=np.float64)[:, None]
    xx = np.arange(ntx * _TILE_W, dtype=np.float64)[None, :]
    for Hinv in Hinvs:
        w = Hinv[2, 0] * xx + Hinv[2, 1] * yy + Hinv[2, 2]
        sx = (Hinv[0, 0] * xx + Hinv[0, 1] * yy + Hinv[0, 2]) / w
        sy = (Hinv[1, 0] * xx + Hinv[1, 1] * yy + Hinv[1, 2]) / w
        for d, band, axis in ((sy - yy, band_y, "y"), (sx - xx, band_x, "x")):
            t = d.reshape(nty, _TILE_H, ntx, _TILE_W)
            var = (t.max(axis=(1, 3)) - t.min(axis=(1, 3))).max()
            need = int(np.ceil(var)) + support + 1
            if need > band:
                raise AssertionError(
                    f"tiled warp band_{axis}={band} undersized: true "
                    f"in-tile variation {var:.3f} px needs >= {need}")


def warp_frame_bu(data_bu: np.ndarray, H_td: np.ndarray,
                  out_shape: Tuple[int, int],
                  interpolation: int = INTER_LINEAR) -> np.ndarray:
    """Warp a bottom-up (C, H, W) uint16 frame by a homography expressed
    in TOP-DOWN star coordinates (cvTransformImage + surrounding flips,
    registration.c:720-722). Returns uint16 (C, oh, ow) bottom-up."""
    c = data_bu.shape[0]
    Hinv = np.linalg.inv(np.asarray(H_td, dtype=np.float64))
    Hinv_j = jnp.asarray(Hinv, jnp.float32)
    band = _tiled_plan(Hinv, tuple(out_shape), data_bu.shape[1:],
                       interpolation)
    out = np.empty((c,) + tuple(out_shape), dtype=np.uint16)
    for ch in range(c):
        td = jnp.asarray(np.ascontiguousarray(data_bu[ch][::-1]))
        if band is not None:
            warped = _warp_perspective_tiled(
                td.astype(jnp.float32), Hinv_j, tuple(out_shape),
                interpolation, *band)
        else:
            warped = warp_perspective(td, Hinv_j, tuple(out_shape),
                                      interpolation)
        # OpenCV saturate_cast: round-to-nearest-even then clamp
        w = np.asarray(warped)
        out[ch] = np.clip(np.rint(w), 0, 65535).astype(np.uint16)[::-1]
    return out


@functools.partial(jax.jit, static_argnames=("out_shape", "interpolation",
                                             "band"))
def _warp_layer_dev(layer_bu, Hinv, out_shape, interpolation, band=None):
    td = layer_bu[::-1]
    if band is not None:
        warped = _warp_perspective_tiled(td.astype(jnp.float32), Hinv,
                                         out_shape, interpolation,
                                         band[0], band[1], band[2])
    else:
        warped = warp_perspective(td, Hinv, out_shape, interpolation)
    word = jnp.clip(jnp.rint(warped), 0, 65535).astype(jnp.uint16)
    return word[::-1]


@functools.partial(jax.jit, static_argnames=("out_shape", "interpolation",
                                             "band"))
def _warp_frame_dev(frame_bu, Hinv, out_shape, interpolation, band=None):
    def one(layer):
        return _warp_layer_dev(layer, Hinv, out_shape, interpolation, band)
    return jax.vmap(one)(frame_bu)


def warp_frame_dev(frame_dev_bu, H_td: np.ndarray,
                   out_shape: Tuple[int, int],
                   interpolation: int = INTER_LINEAR):
    """All-channel device warp: (C, H, W) uint16 in, (C, oh, ow) uint16
    out, one program instead of per-channel host round-trips."""
    Hinv = np.linalg.inv(np.asarray(H_td, dtype=np.float64))
    band = _tiled_plan(Hinv, tuple(out_shape),
                       tuple(frame_dev_bu.shape[1:]), interpolation)
    return _warp_frame_dev(frame_dev_bu, jnp.asarray(Hinv, jnp.float32),
                           tuple(out_shape), interpolation, band)


@functools.partial(jax.jit, static_argnames=("out_shape", "interpolation",
                                             "band"))
def _warp_batch_dev(layers_bu, Hinvs, out_shape, interpolation, band=None):
    # lax.map (not vmap): every frame runs the identical single-frame
    # warp program, so sharding the frame axis is partition-invariant.
    def one(t):
        layer, Hinv = t
        return _warp_layer_dev(layer, Hinv, out_shape, interpolation, band)
    return jax.lax.map(one, (layers_bu, Hinvs))


@functools.lru_cache(maxsize=None)
def _warp_batch_fn(out_shape: Tuple[int, int], interpolation: int,
                   band=None):
    """Stable partial for run_frames_sharded's compile cache."""
    return functools.partial(_warp_batch_dev, out_shape=out_shape,
                             interpolation=interpolation, band=band)


def warp_batch_dev(layers_bu, Hs_td: np.ndarray,
                   out_shape: Tuple[int, int],
                   interpolation: int = INTER_LINEAR, mesh=None):
    """Frame-batched device warp: (F, H, W) layers with per-frame 3x3
    homographies (F, 3, 3) -> (F, oh, ow) uint16, one device program.
    Near-identity warps (all registration warps) run the tiled banded
    sampler — dense FMAs instead of gathers —
    with the band sized for the WORST frame so every frame runs the
    identical program (partition invariance preserved).
    With ``mesh`` the frame axis shards over it (shard_map with the
    same per-frame body — no collectives, bit-identical to unsharded)."""
    Hinvs = np.linalg.inv(np.asarray(Hs_td, dtype=np.float64))
    # .shape works for np and device arrays alike (no transfer)
    band = _tiled_plan(Hinvs, tuple(out_shape),
                       tuple(layers_bu.shape[1:]), interpolation)
    fn = _warp_batch_fn(tuple(out_shape), interpolation, band)
    if mesh is not None:
        from siriltpu.parallel.mesh import run_frames_sharded
        return run_frames_sharded(fn, mesh, np.asarray(layers_bu),
                                  Hinvs.astype(np.float32))
    return fn(layers_bu, jnp.asarray(Hinvs, jnp.float32))


def warp_layer_dev(layer_dev_bu, H_td: np.ndarray,
                   out_shape: Tuple[int, int],
                   interpolation: int = INTER_LINEAR):
    """Device-resident single-layer variant of :func:`warp_frame_bu`:
    the flips, the OpenCV saturate_cast rounding and the uint16 store
    all stay on device, and the input is an already-uploaded layer —
    callers that just found stars on the same layer avoid a second
    host→device pass and read back HALF the bytes (uint16, not the f32
    intermediate). Returns a device (oh, ow) uint16 array."""
    Hinv = np.linalg.inv(np.asarray(H_td, dtype=np.float64))
    band = _tiled_plan(Hinv, tuple(out_shape),
                       tuple(layer_dev_bu.shape), interpolation)
    return _warp_layer_dev(layer_dev_bu, jnp.asarray(Hinv, jnp.float32),
                           tuple(out_shape), interpolation, band)


__all__ = ["warp_perspective", "warp_frame_bu", "warp_layer_dev",
           "warp_frame_dev", "warp_batch_dev", "INTER_NEAREST",
           "INTER_LINEAR", "INTER_AREA", "INTER_CUBIC", "INTER_LANCZOS4"]
