"""Star detection ("peaker").

Reference: src/algos/star_finder.c:103-255.

Pipeline:
1. threshold = (WORD)median + sigma·(WORD)sigma of the layer statistics
   (``Compute_threshold`` :39-57, both stats truncated to WORD first);
2. detection image = plane 2 of a 3-plane B-spline à-trous transform —
   i.e. the twice-smoothed image (:141, core/siril.c:1285);
3. 8-neighbor local maxima within (threshold, norm) in TOP-DOWN row
   order, ties broken towards the first-scanned pixel: an equal neighbor
   above or to the left disqualifies (:176-199);
4. a (2R × 2R) box around each peak from the REAL image is PSF-fitted
   without angle (:216); results pass ``is_star`` (:59-78) including the
   roundness test fwhmy/fwhmx >= roundness;
5. star position = peak + subpixel − R − 1 (:222-223); stars sorted by
   magnitude, capped at MAX_STARS = 50000 (src/core/siril.h:177).

Divergence from the reference, on purpose: peaker fills the fit box
TRANSPOSED (star_finder.c:227-235 sets z[x][y]), which swaps the fitted
subpixel offsets and sx/sy. We fit in the natural orientation — equal
for symmetric stars, strictly better positions for elongated ones.

Star coordinates are reported in top-down (x, y) image coordinates like
the reference GUI/star lists.

Device-native: detection is one fused device program (wavelet planes +
compare-with-8-rolls); box gather + PSF fits are one vmapped program
over a padded candidate list.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from siriltpu.core.frame import Rect
from siriltpu.ops.psf import fit_psf_batch
from siriltpu.ops.stats import STATS_BASIC, statistics
from siriltpu.ops.wavelets import TO_PAVE_BSPLINE, atrous_transform

MAX_STARS = 50000
WAVELET_SCALE = 3

# opt-in stage timing (SIRILTPU_PROF=1): peaker appends
# (stats, detect_sync, fit_sync, host_loop) seconds per call
PROF_TIMES: List[tuple] = []


def _prof_enabled() -> bool:
    import os
    return bool(os.environ.get("SIRILTPU_PROF"))


@dataclass
class StarFinderParams:
    """starFinder tuning (src/algos/star_finder.h:6-11; GUI defaults)."""
    radius: int = 10
    sigma: float = 1.0
    roundness: float = 0.5


@dataclass
class Star:
    xpos: float
    ypos: float
    mag: float
    fwhmx: float
    fwhmy: float
    A: float
    B: float
    sx: float
    sy: float
    angle: float = 0.0
    rmse: float = 0.0
    layer: int = 0

    @property
    def pos(self):
        return (self.xpos, self.ypos)


@functools.partial(jax.jit, static_argnames=("radius",))
def _detect_peaks(wave_td: jnp.ndarray, threshold: jnp.ndarray,
                  norm: jnp.ndarray, radius: int,
                  bounds: jnp.ndarray) -> jnp.ndarray:
    """Local-maximum mask on the top-down wavelet image.

    bounds = (x0, y0, x1, y1) detection window (top-down coords)."""
    h, w = wave_td.shape
    p = wave_td.astype(jnp.int32)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    x0, y0, x1, y1 = bounds[0], bounds[1], bounds[2], bounds[3]
    inwin = ((yy >= y0 + radius) & (yy < y1 - radius) &
             (xx >= x0 + radius) & (xx < x1 - radius))
    ok = (p > threshold) & (p < norm) & inwin

    pad = jnp.pad(p, 1, constant_values=jnp.iinfo(jnp.int32).max)

    def nb(dy, dx):
        return pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nv = nb(dy, dx)
            # tie rule (star_finder.c:189-196): an equal neighbor with
            # (dx<=0 and dy<=0) or (dx>0 and dy<0) disqualifies
            if (dx <= 0 and dy <= 0) or (dx > 0 and dy < 0):
                ok = ok & (nv < p)
            else:
                ok = ok & (nv <= p)
    return ok


@functools.partial(jax.jit, static_argnames=("radius", "nmax"))
def _gather_boxes(real_td: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray,
                  radius: int, nmax: int) -> jnp.ndarray:
    """Extract (nmax, 2R, 2R) boxes at top-down peak coords."""
    def one(y, x):
        return jax.lax.dynamic_slice(real_td, (y - radius, x - radius),
                                     (2 * radius, 2 * radius))
    return jax.vmap(one)(ys, xs)


def peaker(layer_bu: np.ndarray, *, params: Optional[StarFinderParams] = None,
           area: Optional[Rect] = None, layer_index: int = 0,
           norm: Optional[int] = None, return_device: bool = False,
           layer_dev=None):
    """Find stars on a bottom-up uint16 layer; returns stars sorted by
    magnitude (brightest first), positions in top-down coords.

    With ``return_device`` the result is ``(stars, layer_dev)`` where
    ``layer_dev`` is the already-uploaded device copy of the layer —
    registration reuses it for the warp instead of paying a second
    host→device transfer. Callers that
    prefetched the upload (``jax.device_put`` is async) pass it via
    ``layer_dev``; the transfer then drains under the previous frame's
    host work instead of serializing here."""
    sf = params or StarFinderParams()
    layer_bu = np.asarray(layer_bu)
    h, w = layer_bu.shape

    prof = _prof_enabled()
    if prof:
        import time
        t0 = time.perf_counter()
    st = statistics(layer_bu, option=STATS_BASIC, nullcheck=True,
                    skip_noise=True)
    if st is None:
        return ([], None) if return_device else []
    if norm is None:
        norm = int(st.norm_value)
    threshold = int(np.uint16(st.median) + sf.sigma * np.uint16(st.sigma))
    bg = st.median

    # single host->device upload (the layer is reused by both the
    # wavelet transform and the fit-box gather)
    if layer_dev is None:
        layer_dev = jnp.asarray(layer_bu)
    # wavelet smooth (plane 2 of 3) on device, then flip to top-down
    tr = atrous_transform(layer_dev, WAVELET_SCALE, TO_PAVE_BSPLINE)
    from siriltpu.utils.rounding import round_to_word
    wave_bu = round_to_word(tr[WAVELET_SCALE - 1])
    wave_td = wave_bu[::-1]
    real_td = layer_dev[::-1]

    if area is not None:
        bounds = jnp.asarray([area.x, area.y, area.x + area.w,
                              area.y + area.h], jnp.int32)
    else:
        bounds = jnp.asarray([0, 0, w, h], jnp.int32)

    mask = _detect_peaks(wave_td, jnp.int32(threshold),
                         jnp.int32(norm), sf.radius, bounds)
    # keep the peak COORDINATES device-side via top-k on the wavelet
    # value (transfers K indices, not an H*W mask); brightness-capped
    # rather than scan-order-capped.
    score = jnp.where(mask, wave_td.astype(jnp.int32), -1)
    if prof:
        t1 = time.perf_counter()
    krow = min(256, w)
    kmax = min(8192, h * krow)
    rv, ri = jax.lax.top_k(score, krow)                      # (h, krow)
    flat_idx = (jnp.arange(h, dtype=jnp.int32)[:, None] * w
                + ri.astype(jnp.int32))
    vals, sel = jax.lax.top_k(rv.reshape(-1), kmax)
    idx = flat_idx.reshape(-1)[sel]
    # one transfer for both vectors — every device->host fetch pays a
    # full round trip on this link
    vi = np.asarray(jnp.stack([vals, idx]))
    vals, idx = vi[0], vi[1]
    keep = vals >= 0
    ys = (idx[keep] // w).astype(np.int64)
    xs = (idx[keep] % w).astype(np.int64)
    if ys.size == 0:
        return ([], layer_dev) if return_device else []
    if ys.size > MAX_STARS:
        ys, xs = ys[:MAX_STARS], xs[:MAX_STARS]

    # pad candidate count to stabilize jit cache
    n = ys.size
    nmax = 1 << max(4, int(np.ceil(np.log2(n))))
    ys_p = np.concatenate([ys, np.full(nmax - n, sf.radius)]).astype(np.int32)
    xs_p = np.concatenate([xs, np.full(nmax - n, sf.radius)]).astype(np.int32)

    if prof:
        t2 = time.perf_counter()
    boxes = _gather_boxes(real_td, jnp.asarray(ys_p), jnp.asarray(xs_p),
                          sf.radius, nmax)
    fit = fit_psf_batch(boxes, jnp.full((nmax,), bg, jnp.float32),
                        fit_angle=False, norm=float(norm))

    # fetch all fit fields in ONE device->host transfer (was 10 separate
    # np.asarray round trips)
    packed = np.asarray(jnp.stack([
        fit.A, fit.B, fit.x0, fit.y0, fit.sx, fit.sy,
        fit.fwhmx, fit.fwhmy, fit.mag, fit.ok.astype(jnp.float32)]))
    if prof:
        t3 = time.perf_counter()
    stars = _build_stars(packed, ys, xs, n, sf, layer_index)
    if prof:
        t4 = time.perf_counter()
        PROF_TIMES.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3))
    return (stars, layer_dev) if return_device else stars


def _build_stars(packed: np.ndarray, ys, xs, n: int, sf: StarFinderParams,
                 layer_index: int) -> List[Star]:
    """is_star filtering (star_finder.c:59-78) + Star construction from a
    (10, N) packed fit-field array; sorted by magnitude."""
    A, B, x0, y0, sx, sy, fwx, fwy, mag, okv = packed
    okv = okv != 0.0
    stars: List[Star] = []
    for k in range(n):
        if not okv[k]:
            continue
        if not (np.isfinite(fwx[k]) and np.isfinite(fwy[k])):
            continue
        if not (np.isfinite(x0[k]) and np.isfinite(y0[k]) and
                np.isfinite(mag[k])):
            continue
        if x0[k] <= 0.0 or y0[k] <= 0.0:
            continue
        if A[k] < 0.01:
            continue
        if sx[k] > 200 or sy[k] > 200:
            continue
        if fwx[k] <= 0.0 or fwy[k] <= 0.0:
            continue
        if (fwy[k] / fwx[k]) < sf.roundness:
            continue
        stars.append(Star(
            xpos=float(xs[k] + x0[k] - sf.radius - 1),
            ypos=float(ys[k] + y0[k] - sf.radius - 1),
            mag=float(mag[k]), fwhmx=float(fwx[k]), fwhmy=float(fwy[k]),
            A=float(A[k]), B=float(B[k]), sx=float(sx[k]), sy=float(sy[k]),
            layer=layer_index))
    stars.sort(key=lambda s: s.mag)
    return stars


# ------------------------------------------------------- batched star find

@functools.partial(jax.jit, static_argnames=("radius", "kmax", "nmax"))
def _star_find_batch_dev(layers_bu, thresholds, norms, bgs, *, radius: int,
                         kmax: int, nmax: int):
    """One device program: detect + box-gather + PSF-fit for a BATCH of
    frames (F, H, W). Returns (F, 12, nmax): the 10 packed fit fields of
    :func:`peaker` plus candidate ys/xs rows (invalid slots have
    valid<0). The frame axis is a ``lax.map`` (NOT vmap): every frame
    runs the identical single-frame program, so sharding the leading
    axis over a ``frames`` mesh (run_frames_sharded) is
    partition-invariant — sharded == unsharded bit-for-bit, matching
    the reference's frame-independent OpenMP registration loop
    (registration.c:276-279)."""
    f, h, w = layers_bu.shape

    def one(layer_bu, threshold, norm, bg):
        tr = atrous_transform(layer_bu, WAVELET_SCALE, TO_PAVE_BSPLINE)
        from siriltpu.utils.rounding import round_to_word
        wave_td = round_to_word(tr[WAVELET_SCALE - 1])[::-1]
        real_td = layer_bu[::-1]
        bounds = jnp.asarray([0, 0, w, h], jnp.int32)
        mask = _detect_peaks(wave_td, threshold.astype(jnp.int32),
                             norm.astype(jnp.int32), radius, bounds)
        score = jnp.where(mask, wave_td.astype(jnp.int32), -1)
        krow = min(256, w)
        rv, ri = jax.lax.top_k(score, krow)
        flat_idx = (jnp.arange(h, dtype=jnp.int32)[:, None] * w
                    + ri.astype(jnp.int32))
        vals, sel = jax.lax.top_k(rv.reshape(-1), min(kmax, h * krow))
        idx = flat_idx.reshape(-1)[sel]
        vals_n = vals[:nmax]
        idx_n = idx[:nmax]
        valid = vals_n >= 0
        ys = jnp.where(valid, idx_n // w, radius).astype(jnp.int32)
        xs = jnp.where(valid, idx_n % w, radius).astype(jnp.int32)
        boxes = _gather_boxes(real_td, ys, xs, radius, nmax)
        fit = fit_psf_batch(boxes, jnp.full((nmax,), bg, jnp.float32),
                            fit_angle=False, norm=norm.astype(jnp.float32))
        ok = fit.ok & valid
        return jnp.stack([fit.A, fit.B, fit.x0, fit.y0, fit.sx, fit.sy,
                          fit.fwhmx, fit.fwhmy, fit.mag,
                          ok.astype(jnp.float32),
                          ys.astype(jnp.float32), xs.astype(jnp.float32)])

    return jax.lax.map(lambda t: one(*t),
                       (layers_bu, thresholds, norms, bgs))


@functools.lru_cache(maxsize=None)
def _star_find_batch_fn(radius: int, kmax: int, nmax: int):
    """Stable partial of the batched star find (cached so
    run_frames_sharded can memoize its compiled shard_map wrapper)."""
    return functools.partial(_star_find_batch_dev, radius=radius,
                             kmax=kmax, nmax=nmax)


def peaker_batch(layers_bu: np.ndarray, *,
                 params: Optional[StarFinderParams] = None,
                 layer_index: int = 0, nmax: int = 1024,
                 mesh=None, return_device: bool = False):
    """Star-find a BATCH of bottom-up uint16 layers (F, H, W) in one
    device program; returns one sorted star list per frame.

    Same per-star math as :func:`peaker` (identical device kernels,
    vmapped), with one difference: candidates are capped at the ``nmax``
    BRIGHTEST wavelet peaks per frame instead of the per-frame path's
    full padded list. With ``mesh`` (a Mesh with a ``frames`` axis) the
    batch is sharded so each device star-finds its own frames — the
    device mapping of the reference's OpenMP-over-frames registration
    (registration.c:276-279)."""
    sf = params or StarFinderParams()
    layers_bu = np.asarray(layers_bu)
    f, h, w = layers_bu.shape

    thresholds = np.empty(f, np.int32)
    norms = np.empty(f, np.int32)
    bgs = np.empty(f, np.float32)
    good = np.ones(f, bool)
    for i in range(f):
        st = statistics(layers_bu[i], option=STATS_BASIC, nullcheck=True,
                        skip_noise=True)
        if st is None:
            good[i] = False
            thresholds[i] = norms[i] = 0
            bgs[i] = 0.0
            continue
        norms[i] = int(st.norm_value)
        thresholds[i] = int(np.uint16(st.median)
                            + sf.sigma * np.uint16(st.sigma))
        bgs[i] = st.median

    fn = _star_find_batch_fn(sf.radius, 8192, nmax)
    dev_layers = None
    if mesh is not None:
        from siriltpu.parallel.mesh import run_frames_sharded
        out = np.asarray(run_frames_sharded(
            fn, mesh, layers_bu, thresholds, norms, bgs))
    else:
        # keep the uploaded frames for the caller: the register engine
        # feeds the SAME frames to the warp stage, and sharing the
        # device copy halves the host->device traffic per frame
        dev_layers = jnp.asarray(layers_bu)
        out = np.asarray(fn(dev_layers, jnp.asarray(thresholds),
                            jnp.asarray(norms), jnp.asarray(bgs)))

    result: List[List[Star]] = []
    for i in range(f):
        if not good[i]:
            result.append([])
            continue
        packed = out[i, :10]
        ys = out[i, 10].astype(np.int64)
        xs = out[i, 11].astype(np.int64)
        result.append(_build_stars(packed, ys, xs, nmax, sf, layer_index))
    if return_device:
        return result, dev_layers
    return result


__all__ = ["peaker", "peaker_batch", "Star", "StarFinderParams", "MAX_STARS"]
