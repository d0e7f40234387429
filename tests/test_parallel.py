"""Multi-device sharding on the 8-device virtual CPU mesh (SURVEY §4(d))."""

import numpy as np
import pytest

from siriltpu.parallel.engine import CancelledError, SequenceEngine
from siriltpu.parallel.mesh import make_mesh, pad_frames_to_mesh
from siriltpu.parallel.sharded import (make_sharded_register_stack,
                                       make_sharded_sum_stack)
from siriltpu.testing.synth import make_sequence_frames
from siriltpu.verify import oracle


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.shape["frames"] == 8


def test_sharded_sum_stack_matches_oracle():
    mesh = make_mesh()
    frames, _, shifts = make_sequence_frames(11, 32, 40, seed=90)
    run = make_sharded_sum_stack(mesh)
    got, hi = run(frames[:, 0], shifts)
    want, hi_w = oracle.stack_sum(frames, shifts)
    np.testing.assert_array_equal(got, want[0])
    assert hi == hi_w


def test_sharded_register_stack():
    mesh = make_mesh()
    n = 8
    gen = np.zeros((n, 2), dtype=np.int64)
    gen[1:] = np.random.default_rng(91).integers(-4, 5, (n - 1, 2))
    frames, _, _ = make_sequence_frames(n, 64, 64, seed=91, shifts=gen,
                                        noise_sigma=4.0)
    run = make_sharded_register_stack(mesh, sel=(8, 8, 48))
    out, shifts = run(frames[:, 0])
    np.testing.assert_array_equal(shifts[:, 0], -gen[:, 0])
    np.testing.assert_array_equal(shifts[:, 1], -gen[:, 1])
    # equals the single-device pipeline result
    from siriltpu.stacking.api import stack_frames
    want = stack_frames(frames, method="mean", shifts=shifts,
                        rejection="sigma", sig=(3.0, 3.0))
    np.testing.assert_array_equal(out, want.data[0])


def test_pad_frames():
    mesh = make_mesh()
    assert pad_frames_to_mesh(11, mesh) == 16
    assert pad_frames_to_mesh(16, mesh) == 16


def test_engine_cancellation():
    from siriltpu.io.sequence import internal_sequence
    from siriltpu.core.frame import Frame

    frames = [Frame(np.full((1, 4, 4), i, np.uint16)) for i in range(20)]
    seq = internal_sequence(frames)
    calls = []
    eng = SequenceEngine(chunk=4,
                         cancel_check=lambda: len(calls) >= 6)
    with pytest.raises(CancelledError):
        eng.map_frames(seq, lambda i, f: calls.append(i))
    assert len(calls) < 20


def test_engine_maps_all():
    from siriltpu.io.sequence import internal_sequence
    from siriltpu.core.frame import Frame

    frames = [Frame(np.full((1, 4, 4), i, np.uint16)) for i in range(10)]
    seq = internal_sequence(frames)
    eng = SequenceEngine(chunk=3)
    out = eng.map_frames(seq, lambda i, f: int(f.data[0, 0, 0]))
    assert out == list(range(10))


def test_rows_slab_stack_2d_mesh():
    """P3 row-slab rejection stacking on a 2-D (frames, rows) mesh equals
    the single-device kernel; no collective is needed on the rows axis."""
    import jax.numpy as jnp
    from siriltpu.parallel.mesh import make_mesh
    from siriltpu.parallel.sharded import make_rows_sigma_stack
    from siriltpu.ops.rejection import reject_and_mean

    mesh = make_mesh(("frames", "rows"), shape=(2, 4))
    rng = np.random.default_rng(77)
    f, h, w = 12, 21, 16  # h=21 exercises the pad-to-mesh path (21 % 4 != 0)
    frames = np.clip(rng.normal(2000, 150, (f, h, w)), 0,
                     65535).astype(np.uint16)
    frames[4, 10, 3] = 64000
    run = make_rows_sigma_stack(mesh)
    got = run(frames)
    want, _, _ = reject_and_mean(
        jnp.asarray(frames.reshape(f, h * w), jnp.float32), "sigma",
        (3.0, 3.0))
    np.testing.assert_array_equal(got, np.asarray(want).reshape(h, w))


def test_engine_async_save_order_and_stats():
    """async_save: writes land in frame order on the writer thread, and
    the stats dict records read/compute/save/wall components."""
    import time

    from siriltpu.core.frame import Frame
    from siriltpu.io.sequence import internal_sequence

    frames = [Frame(np.full((1, 4, 4), i, np.uint16)) for i in range(12)]
    seq = internal_sequence(frames)
    saved = []
    stats = {}
    eng = SequenceEngine(chunk=4)

    def slow_save(i, out):
        time.sleep(0.005)        # make the writer measurably busy
        saved.append((i, out))

    out = eng.map_frames(seq, lambda i, f: int(f.data[0, 0, 0]),
                         save_hook=slow_save, async_save=True,
                         stats=stats)
    assert out == list(range(12))
    assert [i for i, _ in saved] == list(range(12))   # FIFO preserved
    assert [v for _, v in saved] == list(range(12))
    assert stats["wall_s"] > 0 and stats["save_s"] > 0
    # the writer ran concurrently: components may exceed the wall
    assert stats["read_s"] >= 0 and stats["compute_s"] >= 0


def test_engine_async_save_error_propagates():
    from siriltpu.core.frame import Frame
    from siriltpu.io.sequence import internal_sequence

    frames = [Frame(np.full((1, 4, 4), i, np.uint16)) for i in range(8)]
    seq = internal_sequence(frames)
    eng = SequenceEngine(chunk=2)

    def bad_save(i, out):
        if i == 3:
            raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        eng.map_frames(seq, lambda i, f: i, save_hook=bad_save,
                       async_save=True)
