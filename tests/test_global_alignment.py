"""Global star alignment: triangle matching, RANSAC homography, warps.
BASELINE config-4 math."""

import numpy as np
import pytest

from siriltpu.core.frame import Frame
from siriltpu.ops.warp import (INTER_CUBIC, INTER_LANCZOS4, INTER_LINEAR,
                               INTER_NEAREST, warp_frame_bu, warp_perspective)
from siriltpu.registration.matching import (Trans, fit_trans, match_lists,
                                            new_star_match, vote_pairs)
from siriltpu.registration.ransac import dlt_homography, find_homography


def make_affine(angle_deg=0.0, scale=1.0, tx=0.0, ty=0.0):
    a = np.radians(angle_deg)
    return np.array([[scale * np.cos(a), -scale * np.sin(a), tx],
                     [scale * np.sin(a), scale * np.cos(a), ty],
                     [0, 0, 1.0]])


def apply_h(H, xy):
    ph = np.column_stack([xy, np.ones(len(xy))]) @ H.T
    return ph[:, :2] / ph[:, 2:3]


@pytest.fixture
def star_sets():
    rng = np.random.default_rng(60)
    ref = rng.uniform(20, 480, size=(40, 2))
    H = make_affine(angle_deg=4.0, scale=1.01, tx=12.3, ty=-7.7)
    # image stars = H^-1(ref): matching should recover H (img -> ref)
    img = apply_h(np.linalg.inv(H), ref)
    img += rng.normal(0, 0.05, img.shape)
    return img, ref, H


def test_vote_pairs_identity():
    rng = np.random.default_rng(61)
    pts = rng.uniform(0, 100, size=(15, 2))
    pairs, votes = vote_pairs(pts, pts)
    assert pairs.shape[0] >= 10
    for ia, ib in pairs[:10]:
        assert ia == ib


def test_new_star_match_recovers_transform(star_sets):
    img, ref, H = star_sets
    res = new_star_match(img, ref)
    assert res is not None
    mi, mr, trans = res
    assert mi.shape[0] >= 30
    # matched pairs are true correspondences
    pred = apply_h(H, mi)
    np.testing.assert_allclose(pred, mr, atol=0.5)


def test_match_with_extra_stars(star_sets):
    """Star lists are brightness-sorted (peaker); spurious detections are
    faint and rank last, and a few bright stars may be missing from one
    list — the bright heads still overlap enough for the triangle vote."""
    img, ref, H = star_sets
    rng = np.random.default_rng(62)
    img2 = np.vstack([img[2:], rng.uniform(0, 500, size=(8, 2))])
    ref2 = np.vstack([ref, rng.uniform(0, 500, size=(6, 2))])
    res = new_star_match(img2, ref2)
    assert res is not None
    mi, mr, _ = res
    pred = apply_h(H, mi)
    d = np.hypot(*(pred - mr).T)
    assert np.median(d) < 0.5


def test_dlt_exact():
    H = np.array([[1.02, 0.03, 5.0], [-0.02, 0.99, -3.0], [1e-5, -2e-5, 1.0]])
    rng = np.random.default_rng(63)
    src = rng.uniform(0, 400, size=(12, 2))
    dst = apply_h(H, src)
    Hs = dlt_homography(src, dst)
    np.testing.assert_allclose(Hs / Hs[2, 2], H / H[2, 2], rtol=1e-6, atol=1e-6)


def test_ransac_rejects_outliers():
    H = make_affine(angle_deg=-2.0, scale=0.98, tx=-4.0, ty=9.0)
    rng = np.random.default_rng(64)
    src = rng.uniform(0, 400, size=(60, 2))
    dst = apply_h(H, src)
    # corrupt 20 correspondences
    dst[:20] += rng.uniform(20, 80, size=(20, 2))
    res = find_homography(src, dst)
    assert res is not None
    Hr, inl = res
    assert inl.sum() >= 38
    assert not inl[:20].any()
    np.testing.assert_allclose(Hr, H / H[2, 2], atol=1e-3)


@pytest.mark.parametrize("interp", [INTER_NEAREST, INTER_LINEAR, INTER_CUBIC,
                                    INTER_LANCZOS4])
def test_warp_identity(interp):
    rng = np.random.default_rng(65)
    img = rng.integers(0, 60000, size=(32, 40)).astype(np.uint16)
    import jax.numpy as jnp
    out = warp_perspective(jnp.asarray(img).astype(jnp.float32),
                           jnp.eye(3), (32, 40), interp)
    np.testing.assert_allclose(np.asarray(out), img.astype(np.float32),
                               atol=0.02)


def test_warp_pure_translation_matches_roll():
    rng = np.random.default_rng(66)
    img = rng.integers(100, 50000, size=(1, 48, 56)).astype(np.uint16)
    # top-down H: translate by (+5, +3): dst(x,y) = src(x-5, y-3)
    H = np.array([[1, 0, 5.0], [0, 1, 3.0], [0, 0, 1.0]])
    out = warp_frame_bu(img, H, (48, 56), INTER_LINEAR)
    # in top-down space dst(x,y)=src(x-5,y-3); check interior equality
    td_src = img[0][::-1]
    td_dst = out[0][::-1]
    np.testing.assert_array_equal(td_dst[10:40, 10:50],
                                  td_src[10 - 3 : 40 - 3, 10 - 5 : 50 - 5])


def test_warp_rotation_content():
    """Rotating a bright blob by H moves it to the predicted position."""
    h = w = 100
    img = np.zeros((1, h, w), dtype=np.uint16)
    img[0, 30:34, 60:64] = 40000  # bottom-up blob
    H = make_affine(angle_deg=10.0, tx=3.0, ty=-2.0)
    out = warp_frame_bu(img, H, (h, w), INTER_LINEAR)
    # predicted top-down position of blob center
    td_y = h - 1 - 31.5
    pred = apply_h(H, np.array([[61.5, td_y]]))[0]
    ys, xs = np.nonzero(out[0][::-1] > 10000)
    cx, cy = xs.mean(), ys.mean()
    assert abs(cx - pred[0]) < 1.0
    assert abs(cy - pred[1]) < 1.0


def test_register_global_star_end_to_end(tmp_path):
    """Full config-4 flow: rotated/translated starfields -> aligned
    sequence on disk + stacking improves sharpness."""
    from siriltpu.io import fits as fits_io
    from siriltpu.io.sequence import check_seq
    from siriltpu.registration.global_star import register_global_star
    from siriltpu.testing.synth import starfield

    h = w = 256
    rng = np.random.default_rng(67)
    base_stars = np.column_stack([
        rng.uniform(30, w - 30, 25), rng.uniform(30, h - 30, 25),
        rng.uniform(8000, 30000, 25), rng.uniform(4, 7, 25)])
    transforms = [make_affine(),
                  make_affine(angle_deg=2.0, tx=4.0, ty=-3.0),
                  make_affine(angle_deg=-1.5, tx=-6.0, ty=2.0),
                  make_affine(angle_deg=0.5, tx=8.0, ty=5.0)]
    d = str(tmp_path)
    for i, T in enumerate(transforms):
        # transform star positions (top-down coords for the warp math;
        # build in bottom-up by mapping positions)
        pos = base_stars[:, :2]
        newpos = apply_h(np.linalg.inv(T), np.column_stack(
            [pos[:, 0], (h - 1) - pos[:, 1]]))
        stars_i = base_stars.copy()
        stars_i[:, 0] = newpos[:, 0]
        stars_i[:, 1] = (h - 1) - newpos[:, 1]
        data, _ = starfield(h, w, 25, seed=67, background=900,
                            noise_sigma=6.0, stars=stars_i)
        fits_io.write_fits(f"{d}/ds{i+1:03d}.fit", Frame(data))
    seq = check_seq(d)[0]
    report = register_global_star(seq, 0)
    assert report.failed == 0
    assert report.registered == 4
    # homography of frame i maps frame stars onto reference stars
    for i, T in enumerate(transforms):
        H = report.homographies[i]
        assert H is not None
        np.testing.assert_allclose(H / H[2, 2], T / T[2, 2], atol=0.08)
    # the new sequence exists and stacks sharply
    seqs = check_seq(d)
    rseq = [s for s in seqs if s.seqname.startswith("r_")]
    assert rseq, f"aligned sequence missing: {[s.seqname for s in seqs]}"
    rseq = rseq[0]
    assert rseq.number == 4
    frames = np.stack([rseq.read_frame(i).data for i in range(4)])
    from siriltpu.stacking.api import stack_frames
    res = stack_frames(frames, method="mean", rejection="sigma")
    # aligned stack preserves star sharpness: peak value close to single
    # frame's peak (misalignment would smear it down)
    assert res.data.max() > 0.8 * frames[0].max()


def test_warp_layer_dev_matches_host_path():
    """The device-resident warp (used when the registration loop reuses
    the star-finder's uploaded layer) is bit-identical to warp_frame_bu."""
    import jax.numpy as jnp

    from siriltpu.ops.warp import (INTER_CUBIC, INTER_LINEAR, warp_frame_bu,
                                   warp_layer_dev)

    rng = np.random.default_rng(3)
    layer = rng.integers(0, 65535, (64, 80)).astype(np.uint16)
    H = np.array([[1.001, 0.002, 1.5],
                  [-0.003, 0.999, -2.25],
                  [1e-6, -2e-6, 1.0]])
    for interp in (INTER_LINEAR, INTER_CUBIC):
        host = warp_frame_bu(layer[None], H, (64, 80), interp)[0]
        dev = np.asarray(warp_layer_dev(jnp.asarray(layer), H, (64, 80),
                                        interp))
        np.testing.assert_array_equal(dev, host)


def test_warp_frame_dev_matches_host_path():
    """The batched all-channel device warp equals the per-channel host
    path bit-for-bit (RGB registration case)."""
    import jax.numpy as jnp

    from siriltpu.ops.warp import INTER_LINEAR, warp_frame_bu, warp_frame_dev

    rng = np.random.default_rng(8)
    frame = rng.integers(0, 65535, (3, 48, 56)).astype(np.uint16)
    H = np.array([[0.999, -0.004, 2.0],
                  [0.005, 1.002, -1.25],
                  [0.0, 0.0, 1.0]])
    host = warp_frame_bu(frame, H, (48, 56), INTER_LINEAR)
    dev = np.asarray(warp_frame_dev(jnp.asarray(frame), H, (48, 56),
                                    INTER_LINEAR))
    np.testing.assert_array_equal(dev, host)


def test_global_align_batch_matches_loop(tmp_path):
    """global_align_batch (one star-find program + one warp program)
    produces the same aligned frames as the per-frame loop."""
    import numpy as np
    from siriltpu.io.sequence import internal_sequence
    from siriltpu.registration.global_star import (global_align_batch,
                                                   register_global_star)
    from siriltpu.testing.synth import starfield

    h = w = 192
    rng = np.random.default_rng(31)
    base = np.column_stack([
        rng.uniform(25, w - 25, 20), rng.uniform(25, h - 25, 20),
        rng.uniform(9000, 30000, 20), rng.uniform(4, 6, 20)])
    frames = []
    for i, (tx, ty) in enumerate([(0, 0), (3, -2), (-4, 5)]):
        st = base.copy()
        st[:, 0] += tx
        st[:, 1] += ty
        data, _ = starfield(h, w, 20, seed=31, background=850,
                            noise_sigma=5.0, stars=st)
        frames.append(data[0])
    layers = np.stack(frames)

    aligned, rep = global_align_batch(layers, 0, nmax=128)
    assert rep.failed == 0 and rep.registered == 3

    seq = internal_sequence([Frame(l[None]) for l in layers])
    out = []
    rep2 = register_global_star(seq, 0, write_output=False,
                                output_frames=out)
    assert rep2.failed == 0
    for i in range(3):
        # same homography -> same warp program -> identical pixels
        np.testing.assert_allclose(rep.homographies[i], rep2.homographies[i],
                                   atol=1e-9)
        np.testing.assert_array_equal(aligned[i], out[i].data[0])


def test_global_align_batch_sharded(tmp_path):
    """Sharded over the 8-device frames mesh == unsharded."""
    import numpy as np
    from siriltpu.parallel.mesh import make_mesh
    from siriltpu.registration.global_star import global_align_batch
    from siriltpu.testing.synth import starfield

    h = w = 128
    rng = np.random.default_rng(77)
    base = np.column_stack([
        rng.uniform(20, w - 20, 15), rng.uniform(20, h - 20, 15),
        rng.uniform(9000, 28000, 15), rng.uniform(4, 6, 15)])
    layers = []
    for i in range(8):
        st = base.copy()
        st[:, 0] += rng.uniform(-4, 4)
        st[:, 1] += rng.uniform(-4, 4)
        data, _ = starfield(h, w, 15, seed=77, background=900,
                            noise_sigma=4.0, stars=st)
        layers.append(data[0])
    layers = np.stack(layers)
    a1, r1 = global_align_batch(layers, 0, nmax=64)
    a2, r2 = global_align_batch(layers, 0, nmax=64, mesh=make_mesh())
    assert r1.registered == r2.registered
    # partition-invariant by construction: the star find and the warp
    # run a per-frame lax.map body, so every frame executes the
    # identical single-frame program under ANY frames-mesh partitioning
    # (the reference's frame-independent OpenMP loop,
    # registration.c:276-279) — sharded == unsharded bit-for-bit.
    for h1, h2 in zip(r1.homographies, r2.homographies):
        np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(a1, a2)


def test_register_global_star_error_cleanup(tmp_path, monkeypatch):
    """If the consume loop dies mid-sequence (r4 advice fix), the loader
    thread must not stay blocked on the full queue and the partially
    written output SER must be closed with a consistent header."""
    import threading

    import siriltpu.ops.starfind as starfind
    from siriltpu.io.sequence import check_seq
    from siriltpu.io.ser import SerFile
    from siriltpu.registration.global_star import register_global_star
    from siriltpu.testing.synth import starfield

    h = w = 128
    rng = np.random.default_rng(3)
    stars = np.column_stack([
        rng.uniform(15, w - 15, 24), rng.uniform(15, h - 15, 24),
        rng.uniform(12000, 30000, 24), rng.uniform(3.5, 5.5, 24)])
    d = str(tmp_path)
    ser = SerFile.create(f"{d}/film.ser", width=w, height=h)
    for i in range(4):
        data, _ = starfield(h, w, 24, seed=3, background=880,
                            noise_sigma=4.0, stars=stars)
        ser.write_frame(Frame(data))
    ser.write_and_close()
    seq = check_seq(d)[0]

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(starfind, "peaker_batch", boom)
    # small chunks so the loader would have further chunks to feed
    n0 = threading.active_count()
    with pytest.raises(RuntimeError, match="device lost"):
        register_global_star(seq, 0, chunk_frames=1)
    # loader reaped (poll briefly: join(timeout) already waited)
    for _ in range(50):
        if threading.active_count() <= n0:
            break
        import time
        time.sleep(0.1)
    assert threading.active_count() <= n0
    # partial output SER closed with a consistent (0-frame) header
    out = SerFile.open(f"{d}/r_film.ser")
    assert out.frame_count == 0


# ----------------------------------------------------- tiled banded warp

def test_tiled_warp_matches_gather_warp():
    """The tiled banded sampler (dense FMAs over static window slices —
    the gather-free path for near-identity registration warps) agrees with
    the reference gather sampler: bit-exact for nearest, within the
    shared float32 coordinate envelope for weighted kernels (both paths
    compute source coordinates in f32, so they may round a 2e-4 px
    coordinate differently — bounded by kernel-slope x local range)."""
    import jax.numpy as jnp

    from siriltpu.ops.warp import (_tiled_plan, _warp_perspective_tiled,
                                   warp_perspective)

    rng = np.random.default_rng(21)
    img = rng.integers(0, 65535, (200, 300)).astype(np.uint16)
    a = np.deg2rad(1.0)
    Hs = [np.array([[1, 0, 3.7], [0, 1, -2.2], [0, 0, 1.0]]),
          np.array([[0.99 * np.cos(a), -0.99 * np.sin(a), 5.0],
                    [0.99 * np.sin(a), 0.99 * np.cos(a), -3.0],
                    [0, 0, 1.0]]),
          np.array([[1.01, 0.004, -1.2], [-0.003, 0.995, 2.4],
                    [2e-6, -1.5e-6, 1.0]])]
    for H in Hs:
        Hinv = np.linalg.inv(H)
        hj = jnp.asarray(Hinv, jnp.float32)
        for interp in (0, 1, 2, 3, 4):
            plan = _tiled_plan(Hinv, (200, 300), img.shape, interp)
            assert plan is not None
            ref = np.asarray(warp_perspective(
                jnp.asarray(img).astype(jnp.float32), hj, (200, 300),
                interp))
            got = np.asarray(_warp_perspective_tiled(
                jnp.asarray(img).astype(jnp.float32), hj, (200, 300),
                interp, *plan))
            d = np.abs(got - ref)
            if interp == 0:
                assert d.max() == 0
            else:
                assert d.max() <= 8.0, (interp, d.max())
                assert np.mean(d > 0.51) < 0.05


def test_tiled_warp_fuzz_random_homographies():
    """Seeded fuzz: random registration-scale homographies (rotation
    ≤1.5°, scale 0.97-1.03, shift ≤12 px, mild perspective) through
    both samplers; every interpolation stays within the f32 coordinate
    envelope and nearest stays exact."""
    import jax.numpy as jnp

    from siriltpu.ops.warp import (_tiled_plan, _warp_perspective_tiled,
                                   warp_perspective)

    rng = np.random.default_rng(77)
    img = rng.integers(0, 65535, (160, 224)).astype(np.uint16)
    for trial in range(6):
        ang = np.deg2rad(rng.uniform(-1.5, 1.5))
        s = rng.uniform(0.97, 1.03)
        tx, ty = rng.uniform(-12, 12, 2)
        p1, p2 = rng.uniform(-4e-6, 4e-6, 2)
        H = np.array([[s * np.cos(ang), -s * np.sin(ang), tx],
                      [s * np.sin(ang), s * np.cos(ang), ty],
                      [p1, p2, 1.0]])
        Hinv = np.linalg.inv(H)
        hj = jnp.asarray(Hinv, jnp.float32)
        for interp in (0, 1, 2, 3, 4):
            plan = _tiled_plan(Hinv, (160, 224), img.shape, interp)
            assert plan is not None, (trial, interp)
            ref = np.asarray(warp_perspective(
                jnp.asarray(img).astype(jnp.float32), hj, (160, 224),
                interp))
            got = np.asarray(_warp_perspective_tiled(
                jnp.asarray(img).astype(jnp.float32), hj, (160, 224),
                interp, *plan))
            d = np.abs(got - ref)
            if interp == 0:
                assert d.max() == 0, (trial,)
            else:
                assert d.max() <= 8.0, (trial, interp, d.max())


def test_tiled_plan_interior_displacement_peak():
    """Regression (r4 advice): the displacement field of a projective map
    is not linear over a tile — here sx - x peaks 7.9 px at the CENTER of
    the single 512-wide tile while the tile corners move <= 0.51 px, so
    the old corner-only plan sized band_x = 4 (true need: 9) and silently
    dropped kernel taps. The fine-grid plan must cover the interior peak
    and match the gather sampler; the exact per-pixel verifier must
    reject the old undersized band."""
    import jax.numpy as jnp
    import pytest

    from siriltpu.ops.warp import (_tiled_plan, _verify_band_exact,
                                   _warp_perspective_tiled, warp_perspective)

    g = 1.2e-4
    a = (g * 256 + 1) ** 2
    Hinv = np.array([[a, 0.0, 0.0], [0.0, 1.0, 0.0], [g, 0.0, 1.0]])
    out_shape = (256, 512)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 65535, (256, 530)).astype(np.uint16)
    hj = jnp.asarray(Hinv, jnp.float32)

    # the old corner-derived band (4 for linear) fails the exact check
    with pytest.raises(AssertionError, match="undersized"):
        _verify_band_exact(Hinv[None], (1, 1), 4, 4, support=2)

    for interp in (0, 1, 4):
        plan = _tiled_plan(Hinv, out_shape, img.shape, interp)
        assert plan is not None
        _verify_band_exact(Hinv[None], (1, 1), plan[0], plan[1],
                           support={0: 1, 1: 2, 4: 8}[interp])
        ref = np.asarray(warp_perspective(
            jnp.asarray(img).astype(jnp.float32), hj, out_shape, interp))
        got = np.asarray(_warp_perspective_tiled(
            jnp.asarray(img).astype(jnp.float32), hj, out_shape,
            interp, *plan))
        d = np.abs(got - ref)
        if interp == 0:
            # this H lands some source coords EXACTLY on .5 rounding
            # boundaries (e.g. sy = 64/1.024 = 62.5) where the two
            # samplers' f32 arithmetic may round apart — allow only
            # those isolated flips (the old corner-plan bug corrupted
            # whole bands of the tile: thousands of pixels)
            assert np.mean(d > 0) <= 1e-4, np.mean(d > 0)
        else:
            assert d.max() <= 8.0, (interp, d.max())
            assert np.mean(d > 0.51) < 0.05


def test_tiled_plan_falls_back_for_wild_warps():
    """Far-from-identity homographies (beyond the band cap) return no
    plan — the gather path handles them."""
    from siriltpu.ops.warp import _tiled_plan

    big_rot = np.deg2rad(30)
    H = np.array([[np.cos(big_rot), -np.sin(big_rot), 0],
                  [np.sin(big_rot), np.cos(big_rot), 0], [0, 0, 1.0]])
    assert _tiled_plan(np.linalg.inv(H), (2048, 3072), (2048, 3072),
                       1) is None


# ------------------------------------------------- interpolation enum parity

def test_interpolation_enum_matches_reference():
    """A migrated siril.cfg stores integers 0-4 which the reference
    passes VERBATIM into cv::resize/warpPerspective (opencv.cpp:89,
    153,262) — so at runtime the values carry OpenCV's real
    InterpolationFlags meanings: 2 = cubic, 3 = area. The reference's
    own enum names (siril.h:257-264 OPENCV_AREA=2/OPENCV_CUBIC=3) are
    swapped relative to OpenCV and mislabel the behavior; we match the
    behavior (PARITY.md "interpolation enum", c_cvgeom goldens)."""
    from siriltpu.ops import warp
    assert warp.INTER_NEAREST == 0
    assert warp.INTER_LINEAR == 1
    assert warp.INTER_CUBIC == 2
    assert warp.INTER_AREA == 3
    assert warp.INTER_LANCZOS4 == 4


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_every_cfg_interpolation_value_warps(interp):
    """All reference cfg values 0-4 execute in warps, rotate and resize
    (AREA falls back to linear in warps, like cv::warpPerspective)."""
    from siriltpu.ops import imops
    rng = np.random.default_rng(12)
    img = rng.integers(0, 60000, size=(1, 24, 28)).astype(np.uint16)
    H = make_affine(angle_deg=4.0, tx=1.0, ty=-1.5)
    out = warp_frame_bu(img, H, (24, 28), interp)
    assert out.shape == (1, 24, 28)
    rot = imops.rotate(img, 7.0, interpolation=interp)
    assert rot.shape == (1, 24, 28)
    up = imops.resize(img, 41, 35, interpolation=interp)
    assert up.shape == (1, 35, 41)
    down = imops.resize(img, 14, 12, interpolation=interp)
    assert down.shape == (1, 12, 14)


def test_area_resize_integer_factor_is_block_mean():
    """Value 3 (cv INTER_AREA — the value the reference's
    'OPENCV_CUBIC' label actually executes) at an integer shrink
    factor == exact block average."""
    from siriltpu.ops import imops
    rng = np.random.default_rng(13)
    img = rng.integers(0, 65535, size=(1, 32, 48)).astype(np.uint16)
    out = imops.resize(img, 12, 8, interpolation=3)
    blocks = img[0].reshape(8, 4, 12, 4).astype(np.float64)
    expect = np.clip(np.rint(blocks.mean(axis=(1, 3))), 0, 65535)
    np.testing.assert_array_equal(out[0], expect.astype(np.uint16))


def test_area_resize_fractional_factor_oracle():
    """Fractional INTER_AREA downscale matches a float64 coverage
    oracle within 1 LSB (device path computes in f32)."""
    from siriltpu.ops import imops
    from siriltpu.ops.imops import _resize_weights
    rng = np.random.default_rng(14)
    img = rng.integers(0, 65535, size=(1, 37, 53)).astype(np.uint16)
    out = imops.resize(img, 21, 15, interpolation=3)
    Wy = _resize_weights(37, 15, 3, True)
    Wx = _resize_weights(53, 21, 3, True)
    expect = Wy @ img[0].astype(np.float64) @ Wx.T
    diff = np.abs(out[0].astype(np.int64)
                  - np.clip(np.rint(expect), 0, 65535).astype(np.int64))
    assert diff.max() <= 1


def test_register_global_translation_only(tmp_path):
    """translation_only mode: regdata gets shiftx=+h02, shifty=-h12
    (registration.c:746-747), no warped sequence is written."""
    import glob
    from siriltpu.io import fits as fits_io
    from siriltpu.io.sequence import check_seq
    from siriltpu.registration.global_star import register_global_star
    from siriltpu.testing.synth import starfield

    h = w = 128
    rng = np.random.default_rng(90)
    base = np.column_stack([
        rng.uniform(20, w - 20, 15), rng.uniform(20, h - 20, 15),
        rng.uniform(9000, 28000, 15), rng.uniform(4, 6, 15)])
    d = str(tmp_path)
    shifts = [(0, 0), (5, -3), (-4, 2)]
    for i, (tx, ty) in enumerate(shifts):
        st = base.copy()
        st[:, 0] += tx
        st[:, 1] += ty
        data, _ = starfield(h, w, 15, seed=90, background=900,
                            noise_sigma=4.0, stars=st)
        fits_io.write_fits(f"{d}/tr{i+1:03d}.fit", Frame(data))
    seq = check_seq(d)[0]
    rep = register_global_star(seq, 0, translation_only=True)
    assert rep.failed == 0 and rep.registered == 3
    reg = seq.regparam[0]
    # star coords are top-down; frame stars at +tx bottom-up means the
    # homography frame->ref carries h02 ~ -tx, h12 ~ -(-ty)... assert
    # the recovered translations undo the planted ones
    for i, (tx, ty) in enumerate(shifts):
        H = rep.homographies[i]
        assert H is not None
        assert abs(H[0, 2] - (-tx)) < 0.5, (i, H[0, 2], tx)
        assert abs(H[1, 2] - ty) < 0.5, (i, H[1, 2], ty)  # top-down y
        assert reg[i].shiftx == int(round(H[0, 2]))
        assert reg[i].shifty == int(round(-H[1, 2]))
    # no r_ output in translation mode
    assert not glob.glob(f"{d}/r_*")


def test_register_global_read_error_surfaces(tmp_path):
    """A frame-read failure in the loader thread surfaces as an
    exception in the caller instead of hanging the chunk loop."""
    from siriltpu.io import fits as fits_io
    from siriltpu.io.sequence import check_seq
    from siriltpu.registration.global_star import register_global_star
    from siriltpu.testing.synth import starfield

    h = w = 128
    d = str(tmp_path)
    for i in range(3):
        data, _ = starfield(h, w, 15, seed=91, background=900,
                            noise_sigma=4.0)
        fits_io.write_fits(f"{d}/er{i+1:03d}.fit", Frame(data))
    seq = check_seq(d)[0]
    seq.read_frame(0)  # populate geometry + let the ref frame load
    import os
    os.truncate(f"{d}/er003.fit", 100)  # corrupt a later frame
    with pytest.raises(Exception):
        register_global_star(seq, 0, write_output=False)
