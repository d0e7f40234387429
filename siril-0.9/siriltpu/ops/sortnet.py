"""Sorting network for the frame axis of stacking blocks.

Stacking only ever sorts the cross-frame pixel vector — F is small (tens
to ~1000) and static — so a Batcher odd-even mergesort NETWORK lowers to
~log2(F)^2 elementwise min/max stages over (P,)-wide rows. On an H100 the
plain stacking path runs as fast with it as with XLA's own
``jnp.sort(axis=0)``, and on the CPU it is 16-30x faster, so it stays
the plain path's sort. The fused GPU kernel runs the same comparators
(:func:`batcher_pairs`, pruned to F wires) inside each pixel column.

The network is generated at trace time for the padded power-of-two size;
padding uses a +max sentinel and is sliced off (multiset-safe).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def batcher_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Compare-exchange pairs of Batcher's odd-even mergesort for size n
    (n must be a power of two). Standard iterative formulation."""
    pairs: List[Tuple[int, int]] = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


@functools.lru_cache(maxsize=None)
def _stages(n: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Group the pairs into parallel stages (no index appears twice in a
    stage) so each stage is one vectorized min/max shuffle."""
    stages: List[List[Tuple[int, int]]] = []
    busy: List[set] = []
    for a, b in batcher_pairs(n):
        placed = False
        # pairs are emitted roughly in dependency order; only append to
        # the LAST stage or start a new one to preserve ordering
        if stages and a not in busy[-1] and b not in busy[-1]:
            stages[-1].append((a, b))
            busy[-1].update((a, b))
            placed = True
        if not placed:
            stages.append([(a, b)])
            busy.append({a, b})
    return tuple(tuple(s) for s in stages)


@functools.lru_cache(maxsize=None)
def _stage_tables(n: int):
    """Per stage: (partner permutation, role) arrays of length n.
    role +1 = take min with partner, -1 = take max, 0 = passthrough.
    Each stage then costs ONE static gather + elementwise select."""
    tables = []
    for stage in _stages(n):
        perm = np.arange(n)
        role = np.zeros(n, dtype=np.int8)
        for a, b in stage:
            perm[a], perm[b] = b, a
            role[a] = 1
            role[b] = -1
        tables.append((perm, role))
    return tuple(tables)


def sort_axis0(x: jnp.ndarray) -> jnp.ndarray:
    """Ascending sort along axis 0 via the odd-even merge network."""
    f = x.shape[0]
    n = 1 << (f - 1).bit_length()
    if n != f:
        if jnp.issubdtype(x.dtype, jnp.floating):
            sentinel = jnp.asarray(jnp.inf, x.dtype)
        else:
            sentinel = jnp.asarray(jnp.iinfo(x.dtype).max, x.dtype)
        pad = jnp.full((n - f,) + x.shape[1:], sentinel, x.dtype)
        x = jnp.concatenate([x, pad], axis=0)

    shape1 = (n,) + (1,) * (x.ndim - 1)
    for perm, role in _stage_tables(n):
        xp = jnp.take(x, jnp.asarray(perm), axis=0)
        r = jnp.asarray(role).reshape(shape1)
        x = jnp.where(r == 1, jnp.minimum(x, xp),
                      jnp.where(r == -1, jnp.maximum(x, xp), x))
    return x[:f]


__all__ = ["sort_axis0", "batcher_pairs"]
