"""À-trous ("pavé") undecimated wavelet transform.

Reference: src/algos/pave.c — linear smoothing kernel [1/4,1/2,1/4]²
(``pave_2d_linear_smooth`` :106-136), B3-spline kernel
[1/16,4/16,6/16,4/16,1/16]² (``pave_2d_bspline_smooth`` :227-286),
transform ``pave_2d_tfo`` (:140-187: plane_k = img_k − smooth_k(img_k),
last plane = final smooth), reconstruction with per-plane weights
(``pave_2d_build`` :191-210), plane extraction (:214-227).

Border handling reproduces ``test_ind`` (pave.c:88-102) as COMPILED,
verified against the C binary in tests/test_c_goldens.py: any negative
index is pinned to 0 (the mirror ``Val = -ind`` is commented out; the
live statement is ``Val = -0``), and an index ≥ N is pinned to N−1 —
i.e. both edges clamp to the boundary pixel.

Step for plane k is 2^k; the smoothing is separable, implemented as two
1-D passes of gathered taps, fully jit/vmap-friendly.

Used by: the ``wavelet``/``wrecons`` commands (src/core/command.c:443-530)
and the star finder, which runs a 3-plane B-spline transform and takes
plane 2 — i.e. the twice-smoothed image (star_finder.c:141,
core/siril.c:1285).
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

TO_PAVE_LINEAR = 1
TO_PAVE_BSPLINE = 2

_LINEAR_TAPS = ((-1, 0.25), (0, 0.5), (1, 0.25))
_BSPLINE_TAPS = ((-2, 1.0 / 16), (-1, 4.0 / 16), (0, 6.0 / 16),
                 (1, 4.0 / 16), (2, 1.0 / 16))


def _test_ind(idx: Array, n: int) -> Array:
    """Border index rule (pave.c:88-102, compiled code): clamp both
    edges (negative → 0, ≥ n → n−1)."""
    return jnp.clip(idx, 0, n - 1)


def _shift_take(img: Array, k: int, axis: int) -> Array:
    """out[i] = img[test_ind(i + k)] along ``axis`` with STATIC k,
    expressed as slices + concat, which fuse into the convolution
    instead of a gather along a full image axis.
    k < 0: clamp-low  -> the first element repeated, then img[:n+k]
    k > 0: clamp-high -> img[k:] then the last element repeated."""
    if k == 0:
        return img
    n = img.shape[axis]
    axis = axis % img.ndim

    def take(lo, hi):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(lo, hi)
        return img[tuple(sl)]

    if k < 0:
        m = -k
        head = jnp.repeat(take(0, 1), m, axis=axis)
        return jnp.concatenate([head, take(0, n - m)], axis=axis)
    tail = jnp.repeat(take(n - 1, n), k, axis=axis)
    return jnp.concatenate([take(k, n), tail], axis=axis)


def _smooth_1d(img: Array, taps, step: int, axis: int) -> Array:
    out = jnp.zeros_like(img)
    for off, w in taps:
        out = out + w * _shift_take(img, off * step, axis)
    return out


def atrous_smooth(img: Array, plane: int, kind: int = TO_PAVE_BSPLINE) -> Array:
    """One smoothing pass at scale ``plane`` (step 2^plane)."""
    step = int(round(2.0 ** plane))
    taps = _BSPLINE_TAPS if kind == TO_PAVE_BSPLINE else _LINEAR_TAPS
    out = _smooth_1d(img, taps, step, axis=-2)
    return _smooth_1d(out, taps, step, axis=-1)


@functools.partial(jax.jit, static_argnames=("nplanes", "kind"))
def atrous_transform(img: Array, nplanes: int, kind: int = TO_PAVE_BSPLINE
                     ) -> Array:
    """Full transform: returns (nplanes, H, W) float32 — detail planes
    0..nplanes-2 and the residual smooth as the last plane."""
    cur = img.astype(jnp.float32)
    planes = []
    for k in range(nplanes - 1):
        sm = atrous_smooth(cur, k, kind)
        planes.append(cur - sm)
        cur = sm
    planes.append(cur)
    return jnp.stack(planes)


@functools.partial(jax.jit, static_argnames=("nplanes", "kind"))
def atrous_reconstruct(planes: Array, weights: Array, nplanes: int = 0,
                       kind: int = 0) -> Array:
    """Weighted reconstruction (pave_2d_build): sum(w_k * plane_k).

    precision=HIGHEST: a float32 contraction may otherwise run in TF32
    on a GPU (about three decimal digits), which would perturb the
    planes that star detection thresholds."""
    return jnp.tensordot(weights.astype(jnp.float32), planes, axes=1,
                         precision=jax.lax.Precision.HIGHEST)


def wavelet_plane_word(layer: np.ndarray, nplanes: int, plane: int,
                       kind: int = TO_PAVE_BSPLINE) -> np.ndarray:
    """``get_wavelet_layers`` equivalent (core/siril.c:1285-1337): extract
    one plane of the transform of a uint16 layer and convert back to WORD.

    ``reget_rawdata`` (reconstr.c:120-139) rescales by 65535/max if the
    max exceeds 65535, then round_to_WORD (negatives clamp to 0)."""
    from siriltpu.utils.rounding import np_round_to_word

    tr = atrous_transform(jnp.asarray(layer), nplanes, kind)
    p = np.asarray(tr[plane]).astype(np.float64)
    mx = p.max() if p.size else 0.0
    ratio = 65535.0 / mx if mx > 65535.0 else 1.0
    return np_round_to_word(p * ratio)


def max_nplanes(rx: int, ry: int) -> int:
    """Wavelet plan limit: log2(min(rx, ry)) - 2 (command.c:1506-1512)."""
    return int(np.log2(min(rx, ry))) - 2


__all__ = ["atrous_transform", "atrous_reconstruct", "atrous_smooth",
           "wavelet_plane_word", "max_nplanes", "TO_PAVE_LINEAR",
           "TO_PAVE_BSPLINE"]
