"""Multi-host / multi-slice scale-out (SURVEY §5.8).

The reference is single-node OpenMP; across hosts the same workload
becomes one SPMD program over a mesh that spans every host's devices:

- ``init_distributed`` brings up JAX's multi-process runtime
  (``jax.distributed.initialize``) with an explicit coordinator
  address, world size and rank.
- ``local_frame_indices`` tells each process which global frame indices
  its own chips consume, so each host reads ONLY its shard from disk —
  the per-host input pipeline (the pod-scale analog of the reference's
  per-thread locked-fd block reads, SURVEY P5).
- ``global_frames_from_local`` assembles the global sharded array from
  those process-local reads with zero cross-host data movement.
- ``make_multihost_register_stack`` runs the fused register+reject-stack
  step over the global mesh; GSPMD inserts the cross-host collectives
  (NCCL between GPUs).

Proven by a real 2-process CPU cluster in tests/test_multihost.py and
the driver's ``dryrun_multichip`` multi-process mode.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

_INITIALIZED = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None) -> None:
    """Initialize the multi-process runtime. Idempotent.

    Pass the coordinator address (``host:port``), world size and rank
    explicitly: nothing in a plain GPU or CPU cluster lets JAX infer
    them.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _INITIALIZED = True


def local_frame_indices(sharding, global_shape: Tuple[int, ...]) -> List[int]:
    """Global frame indices (axis 0 of ``global_shape``) that THIS
    process's addressable devices consume under ``sharding``, sorted.

    Each host reads exactly these frames from its copy of the sequence
    (or its shard of a distributed filesystem) and feeds them to
    ``global_frames_from_local`` — no host ever touches another host's
    frames.
    """
    idx_map = sharding.addressable_devices_indices_map(tuple(global_shape))
    frames: set = set()
    for index in idx_map.values():
        sl = index[0]
        start = sl.start or 0
        stop = sl.stop if sl.stop is not None else global_shape[0]
        frames.update(range(start, stop))
    return sorted(frames)


def global_frames_from_local(sharding, local_frames: np.ndarray,
                             global_shape: Tuple[int, ...]):
    """Assemble the global (F, H, W) array from this process's local
    frames (stacked in ``local_frame_indices`` order)."""
    import jax

    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_frames), tuple(global_shape))


def make_multihost_register_stack(mesh, sel: Tuple[int, int, int],
                                  rejection: str = "sigma",
                                  sig=(3.0, 3.0)):
    """Fused register + rejection stack over a (possibly multi-host)
    ``frames`` mesh with per-host input feeding.

    Returns ``run(read_frame, nframes, (h, w)) -> np.ndarray`` where
    ``read_frame(i)`` produces global frame ``i`` as (H, W) uint16 —
    called only for this process's own indices. The stacked (H, W)
    uint16 result is returned replicated on every process.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from siriltpu.parallel.sharded import register_stack_step

    sharding = NamedSharding(mesh, P("frames", None, None))
    step = register_stack_step(sel, rejection, sig)
    jitted = jax.jit(lambda fr: step(fr)[0],
                     in_shardings=sharding,
                     out_shardings=NamedSharding(mesh, P()))

    nmesh = mesh.shape["frames"]

    def run(read_frame: Callable[[int], np.ndarray], nframes: int,
            hw: Tuple[int, int]) -> np.ndarray:
        if nframes % nmesh:
            raise ValueError(
                f"{nframes} frames not divisible by the {nmesh}-way frames "
                f"mesh; pad or filter the sequence to a multiple")
        h, w = hw
        gshape = (nframes, h, w)
        mine = local_frame_indices(sharding, gshape)
        local = np.stack([np.asarray(read_frame(i), dtype=np.uint16)
                          for i in mine])
        garr = global_frames_from_local(sharding, local, gshape)
        out = jitted(garr)
        return np.asarray(out.addressable_data(0))

    return run


__all__ = ["init_distributed", "local_frame_indices",
           "global_frames_from_local", "make_multihost_register_stack"]
