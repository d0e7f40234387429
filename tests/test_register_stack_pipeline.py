"""Fused register+stack pipeline correctness on small shapes."""

import jax.numpy as jnp
import numpy as np

from siriltpu.pipelines.register_stack import register_and_stack
from siriltpu.stacking.api import stack_frames
from siriltpu.testing.synth import make_sequence_frames


def test_pipeline_matches_separate_stages():
    n, h, w = 6, 96, 96
    rng = np.random.default_rng(40)
    gen = rng.integers(-5, 6, size=(n, 2))
    gen[0] = 0
    frames, _, _ = make_sequence_frames(n, h, w, seed=40, shifts=gen,
                                        noise_sigma=4.0)
    mono = frames[:, 0]
    out, shifts, quality = register_and_stack(
        jnp.asarray(mono), sel=(16, 16, 64), rejection="sigma",
        sig=(3.0, 3.0), block_rows=40)
    np.testing.assert_array_equal(shifts[:, 0], -gen[:, 0])
    np.testing.assert_array_equal(shifts[:, 1], -gen[:, 1])
    assert quality.shape == (n,)

    want = stack_frames(frames, method="mean", shifts=shifts,
                        rejection="sigma", sig=(3.0, 3.0))
    np.testing.assert_array_equal(out, want.data[0])


def test_pipeline_small_bench_runs():
    """The benchmark harness compiles, checks the recovered shifts once,
    and reports positive throughput on repeated batches."""
    from siriltpu.pipelines.register_stack import RegisterStackBench
    bench = RegisterStackBench(size=128, nframes=8, block_rows=64)
    assert bench.run() > 0
    assert bench.run(repeats=2) > 0


def test_pipeline_plain_path_matches_default():
    """fused=False forces the plain XLA stack; on the CPU the default
    already is that path, so both agree bit for bit."""
    n, h, w = 6, 64, 64
    frames, _, _ = make_sequence_frames(n, h, w, seed=41, noise_sigma=4.0)
    mono = jnp.asarray(frames[:, 0])
    a, sa, _ = register_and_stack(mono, sel=(8, 8, 48), keep_frames=True)
    b, sb, _ = register_and_stack(mono, sel=(8, 8, 48), keep_frames=True,
                                  fused=False)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)


def test_align_slice_matches_gather_align():
    """align_frames_slice (padded dynamic_slice fast path) must produce
    exactly the gather path's zero-fill shift for every in-margin
    shift, including the extremes."""
    from siriltpu.pipelines.register_stack import (
        ALIGN_MARGIN, _align_frames_impl, align_frames_slice)
    rng = np.random.default_rng(5)
    f, h, w = 7, 40, 56
    frames = jnp.asarray(
        rng.integers(0, 65536, (f, h, w)).astype(np.uint16))
    sx = jnp.asarray([0, 3, -5, ALIGN_MARGIN, -ALIGN_MARGIN, 17, -1],
                     jnp.int32)
    sy = jnp.asarray([0, -2, 7, -ALIGN_MARGIN, ALIGN_MARGIN, -30, 4],
                     jnp.int32)
    want = np.asarray(_align_frames_impl(frames, sx, sy))
    got = np.asarray(align_frames_slice(frames, sx, sy, margin=ALIGN_MARGIN))
    np.testing.assert_array_equal(got, want)


def test_align_frames_auto_device_branch():
    """The on-device slice-vs-gather selection (lax.cond, r4: removes
    the per-batch host sync) must match the gather reference on BOTH
    sides of the margin."""
    import jax.numpy as jnp

    from siriltpu.pipelines.register_stack import (ALIGN_MARGIN,
                                                   _align_frames_impl,
                                                   align_frames_auto_keep)

    rng = np.random.default_rng(4)
    frames = jnp.asarray(rng.integers(0, 65535, (5, 96, 128)).astype(
        np.uint16))
    for lo, hi in ((-6, 6), (-(ALIGN_MARGIN + 30), ALIGN_MARGIN + 30)):
        sx = jnp.asarray(rng.integers(lo, hi + 1, 5).astype(np.int32))
        sy = jnp.asarray(rng.integers(lo, hi + 1, 5).astype(np.int32))
        want = np.asarray(_align_frames_impl(frames, sx, sy))
        got = np.asarray(align_frames_auto_keep(frames, sx, sy))
        np.testing.assert_array_equal(got, want)
