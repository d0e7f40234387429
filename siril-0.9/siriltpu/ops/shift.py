"""Integer translation of images with zero fill — the registration-shift
primitive used by every stacking method.

Reference semantics (src/stacking/stacking.c:298-319, :957-971, :1080-1094):
``out[y, x] = in[y - shifty, x - shiftx]`` for in-bounds source coords, else
untouched (accumulators) / zero (gathers). Rows are bottom-up; shifts come
from regdata.

The reference also skips source index 0 (``if (ii > 0 && ...)``,
stacking.c:305): the input pixel at (y=0, x=0) is never accumulated. This
is reproduced behind ``skip_origin=True`` for bit parity of sum/min/max
stacks.

Device implementation: dynamic ``jnp.roll`` plus an iota mask — no
gather, fuses with downstream arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def shift2d(img: jnp.ndarray, shiftx: jnp.ndarray, shifty: jnp.ndarray,
            fill: jnp.ndarray | int = 0, skip_origin: bool = False) -> jnp.ndarray:
    """Translate the last two axes (y, x) of ``img`` by dynamic integer
    shifts: result[..., y, x] = img[..., y - shifty, x - shiftx] where the
    source is in bounds, else ``fill``.
    """
    h, w = img.shape[-2], img.shape[-1]
    sy = jnp.asarray(shifty, jnp.int32)
    sx = jnp.asarray(shiftx, jnp.int32)
    rolled = jnp.roll(img, (sy, sx), axis=(-2, -1))
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    iy = yy - sy
    ix = xx - sx
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    if skip_origin:
        valid = valid & ~((iy == 0) & (ix == 0))
    return jnp.where(valid, rolled, jnp.asarray(fill, img.dtype))


def shift_mask(shape, shiftx, shifty, skip_origin: bool = False) -> jnp.ndarray:
    """Just the validity mask of :func:`shift2d` (bool, (H, W))."""
    h, w = shape
    sy = jnp.asarray(shifty, jnp.int32)
    sx = jnp.asarray(shiftx, jnp.int32)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    iy = yy - sy
    ix = xx - sx
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    if skip_origin:
        valid = valid & ~((iy == 0) & (ix == 0))
    return valid


__all__ = ["shift2d", "shift_mask"]
