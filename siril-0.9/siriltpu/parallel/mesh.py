"""Device mesh construction and sharding policies.

The reference is single-node shared-memory OpenMP (SURVEY §2.9); its
three parallel patterns map onto device meshes as:

- P2 OpenMP-over-frames  → data parallelism on a ``frames`` mesh axis
  (registration, per-frame quality/stats);
- P3 OpenMP-over-row-blocks → spatial sharding on a ``rows`` axis
  (rejection stacking: every device owns a row slab over ALL frames);
- P6 streaming accumulation → ``lax.scan`` over frame chunks per device
  + one ``psum``/``pmax``/``pmin`` reduction across devices (the one
  true collective of this workload; NCCL over NVLink between GPUs).

Every device reaches every other at the same rate, so meshes are flat:
their shape follows the algorithm, not a physical topology.

Multi-host lives in ``parallel/multihost.py``: ``init_distributed``
(jax.distributed), per-host frame feeding via ``local_frame_indices`` +
``make_array_from_process_local_data``, and the fused register+stack
over the global mesh — proven by a real 2-process CPU cluster in
tests/test_multihost.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axes: Tuple[str, ...] = ("frames",),
              shape: Optional[Tuple[int, ...]] = None,
              devices=None) -> Mesh:
    """Build a mesh over the available devices.

    Default: 1-D mesh over all devices on the ``frames`` axis. Pass
    shape=(a, b) with axes=("frames", "rows") for 2-D layouts.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    n = devs.size
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(devs.reshape(shape), axes)


def frames_sharding(mesh: Mesh) -> NamedSharding:
    """(F, H, W) arrays sharded along the frame axis."""
    return NamedSharding(mesh, P("frames", None, None))


def rows_sharding(mesh: Mesh, axis: str = "frames") -> NamedSharding:
    """(F, H, W) arrays sharded along rows (reusing the mesh axis)."""
    return NamedSharding(mesh, P(None, axis, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_frames_to_mesh(nframes: int, mesh: Mesh,
                       axis: str = "frames") -> int:
    """Padded frame count divisible by the mesh axis size."""
    n = mesh.shape[axis]
    return ((nframes + n - 1) // n) * n


_SHARDED_FN_CACHE: dict = {}


def run_frames_sharded(fn, mesh: Mesh, *arrays):
    """Run ``fn(*arrays)`` with every array's leading (frames) axis
    sharded over ``mesh``, partition-invariantly.

    ``fn`` must be frame-local with a per-frame body (``lax.map`` over
    the leading axis, no cross-frame math): then each device executes
    the identical single-frame program on its local shard and sharded
    == unsharded bit-for-bit — the device analog of the reference's
    frame-independent OpenMP registration loop
    (registration.c:276-279). The frame axis is zero-padded to a
    multiple of the mesh axis size; the output is trimmed back.

    ``fn`` must be a stable (cached) callable — the compiled shard_map
    wrapper is memoized on ``(fn, mesh, nargs)``.
    """
    from jax import shard_map

    f = int(np.asarray(arrays[0]).shape[0])
    fp = pad_frames_to_mesh(f, mesh)
    pad = fp - f
    spec = P("frames")
    key = (fn, mesh, len(arrays))
    wrapped = _SHARDED_FN_CACHE.get(key)
    if wrapped is None:
        wrapped = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(spec,) * len(arrays),
            out_specs=spec))
        _SHARDED_FN_CACHE[key] = wrapped
    put = []
    for a in arrays:
        a = np.asarray(a)
        if pad:
            a = np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        put.append(jax.device_put(a, NamedSharding(mesh, spec)))
    out = wrapped(*put)
    return jax.tree_util.tree_map(lambda o: o[:f], out)


__all__ = ["make_mesh", "frames_sharding", "rows_sharding", "replicated",
           "pad_frames_to_mesh", "run_frames_sharded", "Mesh",
           "NamedSharding", "P"]
