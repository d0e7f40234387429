"""Streaming sum / max / min stacking kernels.

Reference: src/stacking/stacking.c — ``stack_summing`` (:196-355),
``stack_addmax`` (:824-972), ``stack_addmin`` (:979-1128).

Semantics frozen for 1-LSB parity (BASELINE config 1):

- accumulate with integer registration shifts:
  ``acc[y, x] (op)= frame[y - shifty, x - shiftx]`` when source in bounds,
  and NEVER from source index 0 (the ``ii > 0`` test, stacking.c:305) —
  see :mod:`siriltpu.ops.shift`.
- sum: u32/u64 accumulator; if the max accumulated value exceeds 65535 the
  result is rescaled by ``65535/max`` and quantized with round_to_WORD
  (:328-343); otherwise copied with round_to_WORD (identity on ints).
- max: accumulator starts at 0 (:870 calloc); min: starts at 65535
  (:1038 memset 0xFF). No rescale for min/max.

Device design: ``lax.scan`` over a frame-chunk resident on the device with a
donated accumulator — the host streams chunks of frames, so the working
set is bounded like the reference's one-frame-at-a-time loop (P6 in
SURVEY §2.9), but each chunk is fused device work. Multi-device: shard the
frame axis, ``psum`` (sum) / ``pmax``/``pmin`` the accumulators — see
siriltpu/parallel/.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from siriltpu.ops.shift import shift2d
from siriltpu.utils.rounding import round_to_word

Array = jnp.ndarray


# ------------------------------------------------------------ chunk kernels

@functools.partial(jax.jit, donate_argnums=(0,))
def _sum_chunk(acc: Array, frames: Array, shifts: Array) -> Array:
    """acc (C,H,W) uint32 += shifted frames (F,C,H,W) uint16; shifts (F,2)."""

    def body(a, fs):
        frame, sh = fs
        shifted = shift2d(frame.astype(jnp.uint32), sh[0], sh[1],
                          fill=0, skip_origin=True)
        return a + shifted, None

    acc, _ = jax.lax.scan(body, acc, (frames, shifts))
    return acc


@functools.partial(jax.jit, donate_argnums=(0,))
def _max_chunk(acc: Array, frames: Array, shifts: Array) -> Array:
    def body(a, fs):
        frame, sh = fs
        shifted = shift2d(frame, sh[0], sh[1], fill=0, skip_origin=True)
        return jnp.maximum(a, shifted), None

    acc, _ = jax.lax.scan(body, acc, (frames, shifts))
    return acc


@functools.partial(jax.jit, donate_argnums=(0,))
def _min_chunk(acc: Array, frames: Array, shifts: Array) -> Array:
    def body(a, fs):
        frame, sh = fs
        shifted = shift2d(frame, sh[0], sh[1],
                          fill=jnp.uint16(65535), skip_origin=True)
        return jnp.minimum(a, shifted), None

    acc, _ = jax.lax.scan(body, acc, (frames, shifts))
    return acc


@jax.jit
def _finalize_sum(acc: Array) -> Tuple[Array, Array]:
    """Rescale a sum accumulator to uint16 (stacking.c:328-343)."""
    maxim = jnp.max(acc)
    ratio = jnp.where(maxim > 65535,
                      65535.0 / maxim.astype(jnp.float32), 1.0)
    scaled = jnp.where(ratio == 1.0,
                       acc.astype(jnp.float32),
                       acc.astype(jnp.float32) * ratio)
    return round_to_word(scaled), maxim


# ------------------------------------------------------------------ drivers

def _iter_chunks(frames, chunk: int):
    """Yield (start, ndarray chunk) over a (F,C,H,W) array or list of (C,H,W)."""
    n = len(frames)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        if isinstance(frames, np.ndarray):
            yield s, frames[s:e]
        else:
            yield s, np.stack([np.asarray(f) for f in frames[s:e]])


def stack_sum(frames, shifts: Optional[np.ndarray] = None, *,
              chunk: int = 16, exact_rescale: bool = True):
    """Sum-stack frames (iterable/array of (C,H,W) uint16).

    ``shifts``: (F, 2) int (shiftx, shifty) registration data, or None.
    Returns (uint16 (C,H,W) ndarray, hi) where hi = round_to_WORD(max sum),
    matching ``gfit.hi`` (stacking.c:326).

    ``exact_rescale``: perform the final ``sum * 65535/max`` in float64 on
    host (bit-exact vs the reference's double math); the device path is
    float32 (±1 LSB worst case).
    """
    n = len(frames)
    if shifts is None:
        shifts = np.zeros((n, 2), dtype=np.int32)
    shifts = np.asarray(shifts, dtype=np.int32)
    first = np.asarray(frames[0])
    c, h, w = first.shape
    acc = jnp.zeros((c, h, w), dtype=jnp.uint32)
    for s, chunk_np in _iter_chunks(frames, chunk):
        acc = _sum_chunk(acc, jnp.asarray(chunk_np),
                         jnp.asarray(shifts[s : s + len(chunk_np)]))
    if exact_rescale:
        acc_h = np.asarray(jax.device_get(acc)).astype(np.uint64)
        maxim = int(acc_h.max())
        if maxim > 65535:
            from siriltpu.utils.rounding import np_round_to_word
            out = np_round_to_word(acc_h.astype(np.float64) * (65535.0 / maxim))
        else:
            out = acc_h.astype(np.uint16)
        return out, min(maxim, 65535)
    out, maxim = _finalize_sum(acc)
    return np.asarray(jax.device_get(out)), int(min(int(jax.device_get(maxim)), 65535))


def stack_max(frames, shifts: Optional[np.ndarray] = None, *, chunk: int = 16):
    """Keep the brightest pixel (``stack_addmax``)."""
    n = len(frames)
    if shifts is None:
        shifts = np.zeros((n, 2), dtype=np.int32)
    shifts = np.asarray(shifts, dtype=np.int32)
    first = np.asarray(frames[0])
    acc = jnp.zeros(first.shape, dtype=jnp.uint16)
    for s, chunk_np in _iter_chunks(frames, chunk):
        acc = _max_chunk(acc, jnp.asarray(chunk_np),
                         jnp.asarray(shifts[s : s + len(chunk_np)]))
    return np.asarray(jax.device_get(acc))


def stack_min(frames, shifts: Optional[np.ndarray] = None, *, chunk: int = 16):
    """Keep the darkest pixel (``stack_addmin``); untouched pixels stay 65535."""
    n = len(frames)
    if shifts is None:
        shifts = np.zeros((n, 2), dtype=np.int32)
    shifts = np.asarray(shifts, dtype=np.int32)
    first = np.asarray(frames[0])
    acc = jnp.full(first.shape, 65535, dtype=jnp.uint16)
    for s, chunk_np in _iter_chunks(frames, chunk):
        acc = _min_chunk(acc, jnp.asarray(chunk_np),
                         jnp.asarray(shifts[s : s + len(chunk_np)]))
    return np.asarray(jax.device_get(acc))


__all__ = ["stack_sum", "stack_max", "stack_min"]
