"""Sharded multi-device pipelines: register + stack over a device mesh.

The distributed analog of the reference's OpenMP fan-outs (SURVEY §2.9):

- ``sharded_sum_stack``: each device scan-accumulates its frame shard
  (streaming, P6) and a ``psum`` reduces the partial accumulators —
  the one true collective of this workload.
- ``sharded_register_stack``: registration (FFT phase correlation on the
  selection) runs frame-sharded; GSPMD re-shards the aligned frames for
  the cross-frame rejection reduction where every device stacks a row
  slab over ALL frames (the reference's block table, stacking.c:1406,
  across devices).

Everything compiles with N virtual CPU devices
(``xla_force_host_platform_device_count``) — SURVEY §4(d) — which is how
tests validate the multi-device path without hardware.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from siriltpu.ops.fftreg import phase_correlate
from siriltpu.ops.rejection import reject_and_mean
from siriltpu.ops.shift import shift2d
from siriltpu.parallel.mesh import frames_sharding, replicated


# ----------------------------------------------------------- sum stacking

def make_sharded_sum_stack(mesh: Mesh):
    """Streaming per-shard accumulate + psum (P6 + P8)."""

    def local_stack(frames, shifts):
        def body(acc, fs):
            frame, sh = fs
            shifted = shift2d(frame.astype(jnp.uint32), sh[0], sh[1],
                              fill=0, skip_origin=True)
            return acc + shifted, None

        acc0 = jnp.zeros(frames.shape[1:], dtype=jnp.uint32)
        acc0 = jax.lax.pcast(acc0, ("frames",), to="varying")
        acc, _ = jax.lax.scan(body, acc0, (frames, shifts))
        return jax.lax.psum(acc, "frames")

    fn = jax.jit(shard_map(local_stack, mesh=mesh,
                           in_specs=(P("frames"), P("frames")),
                           out_specs=P()))

    def run(frames: np.ndarray, shifts: Optional[np.ndarray] = None):
        f = len(frames)
        n = mesh.shape["frames"]
        pad = (-f) % n
        if shifts is None:
            shifts = np.zeros((f, 2), np.int32)
        if pad:
            frames = np.concatenate(
                [frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
            shifts = np.concatenate([shifts, np.zeros((pad, 2), np.int32)])
        fd = jax.device_put(jnp.asarray(frames), frames_sharding(mesh))
        sd = jax.device_put(jnp.asarray(shifts),
                            NamedSharding(mesh, P("frames", None)))
        acc = fn(fd, sd)
        acc_h = np.asarray(acc).astype(np.uint64)
        maxim = int(acc_h.max())
        from siriltpu.utils.rounding import np_round_to_word
        if maxim > 65535:
            return np_round_to_word(acc_h * (65535.0 / maxim)), min(maxim, 65535)
        return acc_h.astype(np.uint16), maxim

    return run


# ------------------------------------------------- register + reject stack

def register_stack_step(sel: Tuple[int, int, int], rejection: str = "sigma",
                        sig=(3.0, 3.0)):
    """The fused register+reject-stack step on (F, H, W) uint16 frames:
    FFT phase correlation on the selection window, zero-fill integer
    shift, cross-frame rejection mean. Shared by the single-host sharded
    driver and the multi-host driver (parallel/multihost.py)."""
    x0, y0, s = sel

    def step(frames):
        sels = jax.lax.dynamic_slice(
            frames, (0, y0, x0), (frames.shape[0], s, s)).astype(jnp.float32)
        ref_fft = jnp.fft.rfft2(sels[0])
        sx, sy = phase_correlate(ref_fft, sels)
        f, h, w = frames.shape
        rows = jnp.arange(h)[None, :] - sy[:, None]
        cols = jnp.arange(w)[None, :] - sx[:, None]
        rows_c = jnp.clip(rows, 0, h - 1)
        cols_c = jnp.clip(cols, 0, w - 1)
        g = jnp.take_along_axis(frames, rows_c[:, :, None], axis=1)
        g = jnp.take_along_axis(g, cols_c[:, None, :], axis=2)
        mask = ((rows >= 0) & (rows < h))[:, :, None] & \
               ((cols >= 0) & (cols < w))[:, None, :]
        aligned = jnp.where(mask, g, jnp.uint16(0))
        out, _, _ = reject_and_mean(aligned.reshape(f, h * w), rejection, sig)
        return out.reshape(h, w), sx, sy

    return step


def make_sharded_register_stack(mesh: Mesh, sel: Tuple[int, int, int],
                                rejection: str = "sigma",
                                sig=(3.0, 3.0)):
    """jit the fused register+stack with frames sharded on input; XLA
    GSPMD inserts the all-to-all for the cross-frame rejection."""
    step = register_stack_step(sel, rejection, sig)
    jitted = jax.jit(step, in_shardings=frames_sharding(mesh),
                     out_shardings=(replicated(mesh), replicated(mesh),
                                    replicated(mesh)))

    def run(frames: np.ndarray):
        fd = jax.device_put(jnp.asarray(frames), frames_sharding(mesh))
        out, sx, sy = jitted(fd)
        return (np.asarray(out),
                np.stack([np.asarray(sx), np.asarray(sy)], axis=1))

    return run



# --------------------------------------------- row-slab rejection stacking

def make_rows_sigma_stack(mesh: Mesh, rejection: str = "sigma",
                          sig=(3.0, 3.0)):
    """The reference's P3 pattern (OpenMP over row blocks, stacking.c
    block table :1406) at mesh scale: every chip owns a ROW SLAB over
    ALL frames and rejection-stacks it locally — rejection is per-pixel,
    so the rows axis needs no collective at all; the output stays
    row-sharded for a downstream sharded consumer (or gathers on fetch).

    Composable with a 2-D ("frames", "rows") mesh: registration runs
    frame-sharded on the frames axis while stacking re-shards onto rows.
    """
    axis = "rows" if "rows" in mesh.shape else list(mesh.shape)[0]

    def slab_stack(frames):  # (F, H/n, W) local slab
        f, hs, w = frames.shape
        out, _, _ = reject_and_mean(frames.reshape(f, hs * w), rejection,
                                    sig)
        return out.reshape(hs, w)

    # check_vma off: the slab kernel is collective-free, and the
    # rejection while_loop seeds carries from non-varying constants.
    fn = jax.jit(shard_map(slab_stack, mesh=mesh,
                           in_specs=P(None, axis, None),
                           out_specs=P(axis, None), check_vma=False))

    def run(aligned: np.ndarray):
        n = mesh.shape[axis]
        f, h, w = aligned.shape
        pad = (-h) % n
        if pad:
            aligned = np.concatenate(
                [aligned, np.zeros((f, pad, w), aligned.dtype)], axis=1)
        fd = jax.device_put(jnp.asarray(aligned),
                            NamedSharding(mesh, P(None, axis, None)))
        out = np.asarray(fn(fd))
        return out[:h]

    return run


__all__ = ["make_sharded_sum_stack", "make_sharded_register_stack",
           "make_rows_sigma_stack", "register_stack_step"]
