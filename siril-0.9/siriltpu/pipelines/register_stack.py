"""Fused register + stack pipeline — the framework's flagship workload and
the BASELINE north-star benchmark (register + sigma-clip stack of a
100-frame 4096x4096 mono sequence, in frames per second per device).

Combines: FFT phase-correlation shift registration on a square selection
(register_shift_dft semantics), PIPP quality estimation, and
mean-with-rejection stacking — all as device programs over a frame batch.

Structure:
1. ``compute_shifts``: one batched FFT over all frame selections.
2. ``align_frames``: vmapped roll+mask translation (uint16, donated).
3. rejection stack: on a GPU the fused rejection kernel
   (siriltpu/ops/pallas/reject_stack.py) over the whole batch, else per
   row-block sort + masked fixed-point sigma clipping
   (siriltpu/ops/rejection.py).

Multi-device: frames axis sharded for (1) and (2); the rejection stack
re-shards rows (GSPMD inserts the all-to-all), every device stacking its
row slab over all frames — mirroring the reference's OpenMP block
parallelism (stacking.c:1513) across devices.
"""

from __future__ import annotations

import functools
import time
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from siriltpu.ops.fftreg import phase_correlate
from siriltpu.ops.quality import quality_estimate_batch
from siriltpu.ops.rejection import reject_and_mean

Array = jnp.ndarray


@functools.partial(jax.jit, static_argnames=("sel",))
def compute_shifts(frames: Array, ref_index: int, sel: Tuple[int, int, int]):
    """Phase-correlation shifts of every frame against the reference frame
    over the square selection sel = (x0, y0, size) in bottom-up coords."""
    x0, y0, s = sel
    sels = jax.lax.dynamic_slice(
        frames, (0, y0, x0), (frames.shape[0], s, s)).astype(jnp.float32)
    ref_sel = jax.lax.dynamic_index_in_dim(sels, ref_index, axis=0,
                                           keepdims=False)
    ref_fft = jnp.fft.rfft2(ref_sel)
    sx, sy = phase_correlate(ref_fft, sels)
    # the reference frame has shift 0 by construction (self-correlation
    # peaks at 0), but enforce it like the reference does
    sx = sx.at[ref_index].set(0)
    sy = sy.at[ref_index].set(0)
    return sx, sy


def _align_frames_impl(frames: Array, sx: Array, sy: Array) -> Array:
    f, h, w = frames.shape
    rows = jnp.arange(h)[None, :] - sy[:, None]
    cols = jnp.arange(w)[None, :] - sx[:, None]
    row_ok = (rows >= 0) & (rows < h)
    col_ok = (cols >= 0) & (cols < w)
    rows_c = jnp.clip(rows, 0, h - 1)
    cols_c = jnp.clip(cols, 0, w - 1)
    g = jnp.take_along_axis(frames, rows_c[:, :, None], axis=1)
    g = jnp.take_along_axis(g, cols_c[:, None, :], axis=2)
    mask = row_ok[:, :, None] & col_ok[:, None, :]
    return jnp.where(mask, g, jnp.uint16(0))


# Apply integer shifts to all frames (zero fill), uint16 -> uint16.
# Implemented as two axis gathers with clipped per-frame index vectors
# (out[f, y, x] = frames[f, y - sy_f, x - sx_f]).
# The donating variant frees the source device memory for pipelines
# that are done with the raw frames; the keeping variant lets callers
# reuse them (saves a defensive 3.2 GB device copy per call).
align_frames = jax.jit(_align_frames_impl, donate_argnums=(0,))
align_frames_keep = jax.jit(_align_frames_impl)

ALIGN_MARGIN = 64  # static zero-pad for the sliced align fast path


def _align_frames_slice_impl(frames: Array, sx: Array, sy: Array,
                             margin: int = ALIGN_MARGIN) -> Array:
    f, h, w = frames.shape
    padded = jnp.pad(frames, ((0, 0), (margin, margin), (margin, margin)))

    def body(_, i):
        sl = jax.lax.dynamic_slice(
            padded, (i, margin - sy[i], margin - sx[i]), (1, h, w))
        return 0, sl[0]

    _, out = jax.lax.scan(body, 0, jnp.arange(f))
    return out


# Same zero-fill shift semantics as ``align_frames`` for
# |shift| <= margin, as a scanned per-frame ``dynamic_slice`` over a
# zero-padded copy — a straight copy instead of a clipped double
# gather. Callers must
# check the shift bound (dynamic_slice CLAMPS out-of-range starts,
# which would silently change the semantics beyond the margin).
align_frames_slice = jax.jit(_align_frames_slice_impl,
                             static_argnames=("margin",))


def _align_frames_auto_impl(frames: Array, sx: Array, sy: Array,
                            margin: int = ALIGN_MARGIN) -> Array:
    """Pick the sliced fast path vs the clipped-gather general path ON
    DEVICE (lax.cond on the shift bound): the pipeline stays fully
    async — no host scalar sync between registration and stacking."""
    maxshift = jnp.max(jnp.maximum(jnp.abs(sx), jnp.abs(sy)))
    return jax.lax.cond(
        maxshift <= margin,
        lambda fr: _align_frames_slice_impl(fr, sx, sy, margin),
        lambda fr: _align_frames_impl(fr, sx, sy),
        frames)


align_frames_auto = jax.jit(_align_frames_auto_impl,
                            static_argnames=("margin",),
                            donate_argnums=(0,))
align_frames_auto_keep = jax.jit(_align_frames_auto_impl,
                                 static_argnames=("margin",))


@functools.lru_cache(maxsize=None)
def _make_stack_block(rejection: str, sig, fused: bool):
    @jax.jit
    def kernel(block: Array) -> Array:
        f, bh, w = block.shape
        # keep uint16: the sigma window kernel sorts in the input dtype
        vals = block.reshape(f, bh * w)
        out, _, _ = reject_and_mean(vals, rejection, sig, fused=fused)
        return out.reshape(bh, w)

    return kernel


def register_and_stack(frames_dev: Array, *, sel: Tuple[int, int, int],
                       ref_index: int = 0, rejection: str = "sigma",
                       sig=(3.0, 3.0), block_rows: int = 128,
                       with_quality: bool = True, return_device: bool = False,
                       keep_frames: bool = False, fused: bool = True):
    """Full pipeline on a device-resident (F, H, W) uint16 frame batch.

    Returns (stacked (H, W) uint16 np.ndarray, shifts (F,2), quality or None).
    With ``return_device`` the arrays stay on device (for pipelined
    host transfers overlapping the next batch's compute). ``fused=False``
    stacks through the plain XLA path even where the fused kernel applies
    (the reference the kernel is checked and timed against).
    """
    f, h, w = frames_dev.shape
    sx, sy = compute_shifts(frames_dev, ref_index, sel)
    quality = None
    if with_quality:
        # the reference estimates quality on the registration SELECTION,
        # not the full frame (register_shift_dft reads only the selection,
        # registration.c:264,309)
        x0, y0, s = sel
        sels = jax.lax.dynamic_slice(frames_dev, (0, y0, x0), (f, s, s))
        quality = quality_estimate_batch(sels)
    # slice-vs-gather align selection happens on device (lax.cond), so
    # the whole register+stack chain dispatches without a host sync
    aligned = (align_frames_auto_keep if keep_frames
               else align_frames_auto)(frames_dev, sx, sy)
    if not keep_frames:
        frames_dev = None  # donated; drop our reference
    from siriltpu.ops.pallas.reject_stack import fused_applies
    if (fused and rejection == "sigma" and fused_applies(rejection, f)
            and next(iter(aligned.devices())).platform == "gpu"):
        # the fused kernel reads the batch once; row blocks would only
        # add a slice copy each
        block_rows = h
    kernel = _make_stack_block(rejection, tuple(sig), fused)
    out_blocks = [kernel(aligned[:, r0:r0 + block_rows, :])
                  for r0 in range(0, h, block_rows)]
    stacked = (out_blocks[0] if len(out_blocks) == 1
               else jnp.concatenate(out_blocks, axis=0))
    if return_device:
        return stacked, (sx, sy), quality
    shifts = np.stack([np.asarray(sx), np.asarray(sy)], axis=1)
    return (np.asarray(jax.device_get(stacked)), shifts,
            None if quality is None else np.asarray(quality))


@functools.partial(jax.jit, static_argnames=("nframes", "size"))
def _make_bench_frames(key, shifts: Array, nframes: int, size: int) -> Array:
    """Generate the synthetic shifted sequence ON DEVICE, so the
    benchmark input never crosses the host link."""
    kb, kn, kp, ka = jax.random.split(key, 4)
    base = 1200.0 + 60.0 * jax.random.normal(kb, (size, size), jnp.float32)
    # sprinkle bright point structure so registration/quality do real work
    npts = 200
    kpy, kpx = jax.random.split(kp)
    ys = jax.random.randint(kpy, (npts,), 10, size - 10)
    xs = jax.random.randint(kpx, (npts,), 10, size - 10)
    amps = jax.random.uniform(ka, (npts,), minval=5000.0, maxval=40000.0)
    base = base.at[ys, xs].add(amps)

    yy = jnp.arange(size, dtype=jnp.int32)[:, None]
    xx = jnp.arange(size, dtype=jnp.int32)[None, :]

    def one(i):
        noise = 10.0 * jax.random.normal(
            jax.random.fold_in(kn, i), (size, size), jnp.float32)
        sy, sx = shifts[i, 1], shifts[i, 0]
        # ZERO-FILL shift (not circular): out[y,x] = base[y-sy, x-sx] or 0,
        # like a real capture drifting off-frame. The central registration
        # selection never sees the border (|shift| <= 20 << margin), so
        # the recovered-shift assertion stays exact, while the stack edges
        # exercise the reference's zero-fill path on real zero edges.
        rolled = jnp.roll(base, (sy, sx), axis=(0, 1))
        inb = ((yy - sy >= 0) & (yy - sy < size)
               & (xx - sx >= 0) & (xx - sx < size))
        shifted = jnp.where(inb, rolled, 0.0)
        return jnp.clip(shifted + noise, 0, 65535).astype(jnp.uint16)

    return jax.lax.map(one, jnp.arange(nframes))


class RegisterStackBench:
    """Benchmark harness for the north-star metric. All data stays on
    device; the timed section is the full register+stack pipeline."""

    def __init__(self, size: int = 4096, nframes: int = 100,
                 chunk: int = 0, block_rows: int = 256,
                 rejection: str = "sigma", with_quality: bool = True,
                 seed: int = 0):
        self.size = size
        self.nframes = nframes
        self.block_rows = block_rows
        self.rejection = rejection
        self.with_quality = with_quality
        rng = np.random.default_rng(seed)
        self.shifts = rng.integers(-20, 21, size=(nframes, 2)).astype(np.int32)
        self.shifts[0] = 0
        s = min(512, size)
        self.sel = ((size - s) // 2, (size - s) // 2, s)
        self._master = None

    def _gen(self):
        return _make_bench_frames(jax.random.PRNGKey(0),
                                  jnp.asarray(self.shifts),
                                  self.nframes, self.size)

    def _step(self):
        return register_and_stack(
            self._master, sel=self.sel, rejection=self.rejection,
            block_rows=self.block_rows, with_quality=self.with_quality,
            return_device=True, keep_frames=True)

    def run(self, repeats: int = 1) -> float:
        """Sustained register+stack throughput (frames/s) on the device
        holding the frames. Each batch is synced with
        ``block_until_ready``; the first call also compiles and checks the
        recovered shifts against the generated ones."""
        if self._master is None:
            self._master = self._gen()
            stacked, (sx, sy), _ = self._step()
            jax.block_until_ready(stacked)
            if not (np.array_equal(np.asarray(sx), -self.shifts[:, 0])
                    and np.array_equal(np.asarray(sy), -self.shifts[:, 1])):
                raise RuntimeError("registration did not recover the "
                                   "generated shifts")
        reps = max(repeats, 1)
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(self._step())
        return self.nframes * reps / (time.perf_counter() - t0)


__all__ = ["register_and_stack", "compute_shifts", "align_frames",
           "RegisterStackBench"]
