"""Independent parity anchor: diff siriltpu against golden outputs produced
by the REFERENCE'S OWN compiled C kernels.

The fixtures in tests/goldens/*.bin are generated by parity_harness/build.sh,
which compiles /root/reference's statistics.c, quantize.c, demosaicing.c and
verbatim extractions of utils.c's rounding/quicksort and stacking.c's
per-pixel rejection switch (stacking.c:1656-1793), then runs them over seeded
pseudo-random inputs. Inputs are stored alongside outputs, so this test needs
neither a compiler nor the reference tree.

This replaces the round-1 situation where every parity claim was only checked
against float64 re-derivations written by the same author (VERDICT.md,
Missing #2): here both the oracle and the device kernels are checked against
actual C output.
"""

import os
import struct

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(GOLDEN_DIR), reason="goldens not generated")


class Reader:
    def __init__(self, path):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.off = 0

    def eof(self):
        return self.off >= len(self.buf)

    def take(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.buf, self.off)
        self.off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def take_u16s(self, n):
        a = np.frombuffer(self.buf, dtype="<u2", count=n, offset=self.off)
        self.off += 2 * n
        return a.copy()

    def take_f32s(self, n):
        a = np.frombuffer(self.buf, dtype="<f4", count=n, offset=self.off)
        self.off += 4 * n
        return a.copy()

    def take_bytes(self, n):
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b


# ------------------------------------------------------------------ rounding

def test_rounding_vs_c():
    from siriltpu.utils.rounding import (np_round_to_byte, np_round_to_int,
                                         np_round_to_word)
    r = Reader(os.path.join(GOLDEN_DIR, "c_rounding.bin"))
    xs, rints, words, bytes_ = [], [], [], []
    while not r.eof():
        x = r.take("d")
        rints.append(r.take("i"))
        words.append(r.take("H"))
        bytes_.append(r.take("B"))
        r.take("B")  # conv_to_BYTE: display-only helper, no siriltpu analog
        xs.append(x)
    xs = np.asarray(xs)
    assert xs.size > 400
    np.testing.assert_array_equal(np_round_to_int(xs), np.asarray(rints))
    np.testing.assert_array_equal(np_round_to_word(xs),
                                  np.asarray(words, np.uint16))
    np.testing.assert_array_equal(np_round_to_byte(xs),
                                  np.asarray(bytes_, np.uint8))


# ----------------------------------------------------------------- rejection

REJ_NAMES = {0: "none", 1: "percentile", 2: "sigma_masked", 3: "sigmedian",
             4: "winsorized", 5: "linearfit"}


def _read_rejection():
    r = Reader(os.path.join(GOLDEN_DIR, "c_rejection.bin"))
    recs = []
    while not r.eof():
        t = r.take("B")
        kind = r.take("B")
        n = r.take("H")
        sig0 = r.take("d")
        sig1 = r.take("d")
        vec = r.take_u16s(n)
        mean = r.take("H")
        rej0 = r.take("Q")
        rej1 = r.take("Q")
        recs.append((t, kind, n, sig0, sig1, vec, mean, rej0, rej1))
    return recs


def test_rejection_device_vs_c():
    """Every masked device rejection kernel reproduces the compiled C's
    mean and rejection counters exactly, grouped/batched per shape."""
    from siriltpu.ops.rejection import reject_and_mean

    recs = _read_rejection()
    assert len(recs) > 2000
    groups = {}
    for t, kind, n, sig0, sig1, vec, mean, rej0, rej1 in recs:
        groups.setdefault((t, n, sig0, sig1), []).append(
            (vec, mean, rej0, rej1))
    bad = []
    for (t, n, sig0, sig1), items in groups.items():
        vals = np.stack([it[0] for it in items], axis=1)  # (N, nvec)
        want_mean = np.array([it[1] for it in items], np.uint16)
        want_rl = sum(it[2] for it in items)
        want_rh = sum(it[3] for it in items)
        got_mean, rl, rh = reject_and_mean(
            vals.astype(np.float32), REJ_NAMES[t], (sig0, sig1))
        got_mean = np.asarray(got_mean)
        if not np.array_equal(got_mean, want_mean):
            idx = np.nonzero(got_mean != want_mean)[0]
            for i in idx[:3]:
                bad.append((REJ_NAMES[t], n, sig0, sig1,
                            items[i][0].tolist(),
                            int(got_mean[i]), int(want_mean[i])))
        # Rejection counters: exact for every algorithm except the raw
        # f32 linearfit kernel, which cannot resolve the C's
        # double-rounding knife-edges (one golden vector's residual
        # ratio sits within 2.6e-11 of the threshold; its MEAN still
        # matches). The SHIPPED linearfit path is the hybrid, pinned
        # zero-tolerance in test_linearfit_hybrid_bitexact_vs_c; the +-1
        # here documents the raw kernel's knife-edge.
        slack = 1 if REJ_NAMES[t] == "linearfit" else 0
        d_l = abs(int(np.asarray(rl).sum()) - want_rl)
        d_h = abs(int(np.asarray(rh).sum()) - want_rh)
        if d_l > slack or d_h > slack:
            bad.append((REJ_NAMES[t], n, sig0, sig1, "rejcounts",
                        (int(np.asarray(rl).sum()), int(np.asarray(rh).sum())),
                        (want_rl, want_rh)))
    assert not bad, f"{len(bad)} device-kernel mismatches vs C: {bad[:5]}"


def test_rejection_oracle_vs_c():
    """The float64 verification oracle reproduces the compiled C exactly
    (a transcription bug here would poison the whole parity story)."""
    from siriltpu.verify import oracle

    recs = _read_rejection()
    bad = []
    for t, kind, n, sig0, sig1, vec, mean, rej0, rej1 in recs:
        frames = vec.reshape(n, 1, 1, 1)
        got = oracle.stack_mean_rejection(
            frames, np.zeros((n, 2), np.int64), REJ_NAMES[t].replace(
                "_masked", ""), (sig0, sig1))
        if int(got[0, 0, 0]) != int(mean):
            bad.append((REJ_NAMES[t], n, sig0, sig1, vec.tolist(),
                        int(got[0, 0, 0]), int(mean)))
    assert not bad, f"{len(bad)} oracle mismatches vs C: {bad[:5]}"


def test_sigma_window_form_vs_c():
    """The shipped DEFAULT 'sigma' (window kernel + masked fallback on the
    degenerate break path) must reproduce the compiled C exactly — mean
    AND rejection counters — on every golden vector (VERDICT weak #4)."""
    from siriltpu.ops.rejection import reject_and_mean

    recs = [x for x in _read_rejection() if x[0] == 2]
    bad = []
    for t, kind, n, sig0, sig1, vec, mean, rej0, rej1 in recs:
        got_mean, rl, rh = reject_and_mean(
            vec.reshape(n, 1).astype(np.float32), "sigma", (sig0, sig1))
        if (int(np.asarray(got_mean)[0]) != int(mean)
                or int(np.asarray(rl)[0]) != rej0
                or int(np.asarray(rh)[0]) != rej1):
            bad.append((n, sig0, sig1, int(np.asarray(got_mean)[0]),
                        int(mean)))
    assert not bad, f"{len(bad)} default-sigma mismatches vs C: {bad[:5]}"


# ---------------------------------------------------------------- statistics

def test_statistics_vs_c():
    from siriltpu.core.frame import Rect
    from siriltpu.ops.stats import STATS_EXTRA, statistics

    r = Reader(os.path.join(GOLDEN_DIR, "c_statistics.bin"))
    ncases = 0
    while not r.eof():
        nx = r.take("H")
        ny = r.take("H")
        nullcheck = r.take("B")
        selflag = r.take("B")
        sx, sy, sw, sh = r.take("hhhh")
        img = r.take_u16s(nx * ny).reshape(ny, nx)
        have = r.take("B")
        sel = Rect(sx, sy, sw, sh) if selflag else None
        got = statistics(img, 0, selection=sel, option=STATS_EXTRA,
                         nullcheck=bool(nullcheck))
        if not have:
            assert got is None
            continue
        total, ngood = r.take("q"), r.take("q")
        (mean, avgdev, mad, median, sigma, bgnoise, vmin, vmax, sqrtbwmv,
         location, scale, normv) = r.take("d" * 12)
        ncases += 1
        assert got is not None, (nx, ny, nullcheck, selflag)
        ctx = (nx, ny, nullcheck, selflag, ncases)
        assert got.total == total and got.ngoodpix == ngood, ctx
        assert got.median == median and got.mad == mad, ctx
        assert got.min == vmin and got.max == vmax, ctx
        assert got.norm_value == normv, ctx
        # integer-exact sums in f64: equality expected, tiny tolerance for
        # the recurrence-vs-sum accumulations (avgDev/sd in long double)
        np.testing.assert_allclose(got.mean, mean, rtol=1e-13, atol=0, err_msg=str(ctx))
        np.testing.assert_allclose(got.sigma, sigma, rtol=1e-12, atol=1e-12, err_msg=str(ctx))
        np.testing.assert_allclose(got.avgdev, avgdev, rtol=1e-12, atol=0, err_msg=str(ctx))
        np.testing.assert_allclose(got.sqrtbwmv, sqrtbwmv, rtol=1e-10,
                                   atol=1e-12, err_msg=str(ctx))
        np.testing.assert_allclose(got.bgnoise, bgnoise, rtol=1e-10,
                                   atol=1e-12, err_msg=str(ctx))
        np.testing.assert_allclose(got.location, location, rtol=1e-10,
                                   atol=1e-9, err_msg=str(ctx))
        np.testing.assert_allclose(got.scale, scale, rtol=1e-9, atol=1e-9,
                                   err_msg=str(ctx))
    assert ncases >= 40


# ------------------------------------------------------------------ quantize

def test_quantize_noise_battery_vs_c():
    from siriltpu.ops.stats import fn_noise1, img_stats_noise

    r = Reader(os.path.join(GOLDEN_DIR, "c_quantize.bin"))
    ncases = 0
    while not r.eof():
        nx = r.take("H")
        ny = r.take("H")
        nullcheck = r.take("B")
        r.take("B")  # kind
        img = r.take_u16s(nx * ny).reshape(ny, nx)
        status = r.take("i")
        ngood = r.take("q")
        vmin, vmax = r.take("H"), r.take("H")
        mean, sigma, n1, n2, n3, n5 = r.take("dddddd")
        assert status == 0
        ncases += 1
        ctx = (nx, ny, nullcheck, ncases)
        g_ngood, g_min, g_max, g_n2, g_n3, g_n5 = img_stats_noise(
            img, bool(nullcheck))
        assert g_ngood == ngood, ctx
        assert g_min == vmin and g_max == vmax, ctx
        np.testing.assert_allclose(g_n3, n3, rtol=1e-12, atol=0, err_msg=str(ctx))
        np.testing.assert_allclose(g_n5, n5, rtol=1e-12, atol=0, err_msg=str(ctx))
        np.testing.assert_allclose(g_n2, n2, rtol=1e-12, atol=0, err_msg=str(ctx))
        g_n1 = fn_noise1(img, bool(nullcheck))
        np.testing.assert_allclose(g_n1, n1, rtol=1e-10, atol=1e-12, err_msg=str(ctx))
        # mean/sigma from FnMeanSigma: integer sums, exact
        a = img.astype(np.float64)
        vals = a[a != 0] if nullcheck else a.reshape(-1)
        if vals.size > 1:
            m = vals.sum() / vals.size
            s = np.sqrt((vals * vals).sum() / vals.size - m * m)
            np.testing.assert_allclose(m, mean, rtol=1e-14, err_msg=str(ctx))
            np.testing.assert_allclose(s, sigma, rtol=1e-12, atol=1e-12, err_msg=str(ctx))
    assert ncases >= 20


# ------------------------------------------------------------------ demosaic

PATTERNS = {0: "RGGB", 1: "BGGR", 2: "GBRG", 3: "GRBG"}
METHODS = {0: "bilinear", 1: "nearest", 2: "vng", 3: "ahd", 4: "super_pixel"}


def test_demosaic_vs_c():
    from siriltpu.ops.demosaic import debayer_buffer

    r = Reader(os.path.join(GOLDEN_DIR, "c_demosaic.bin"))
    ncases = 0
    while not r.eof():
        w = r.take("H")
        h = r.take("H")
        method = r.take("B")
        pattern = r.take("B")
        img = r.take_u16s(w * h).reshape(h, w)
        ow = r.take("H")
        oh = r.take("H")
        out = r.take_u16s(3 * ow * oh).reshape(oh, ow, 3)
        ncases += 1
        got = debayer_buffer(img, PATTERNS[pattern], METHODS[method])
        ctx = (METHODS[method], PATTERNS[pattern], w, h)
        assert got.shape[-2:] == (oh, ow) or got.shape[:2] == (oh, ow) or \
            got.shape == (3, oh, ow), (ctx, got.shape)
        ga = np.asarray(got)
        if ga.shape == (3, oh, ow):          # planar (C,H,W)
            ga = np.moveaxis(ga, 0, -1)
        if method == 3:  # AHD runs CIELAB in f32 on device: allow 1 LSB
            diff = np.abs(ga.astype(np.int32) - out.astype(np.int32))
            assert diff.max() <= 1, (ctx, diff.max())
        else:
            np.testing.assert_array_equal(ga, out, err_msg=str(ctx))
    assert ncases == 60


# ------------------------------------------------------------------- quality

def test_quality_vs_c():
    """PIPP quality estimator vs the compiled reference quality.c
    (subsample pyramid + histo stretch + 3x3 smooth + gradient energy)."""
    from siriltpu.ops.quality import quality_estimate

    r = Reader(os.path.join(GOLDEN_DIR, "c_quality.bin"))
    ncases = 0
    while not r.eof():
        nx = r.take("H")
        ny = r.take("H")
        qtype = r.take("B")
        kind = r.take("B")
        img = r.take_u16s(nx * ny).reshape(ny, nx)
        want = r.take("d")
        ncases += 1
        got = quality_estimate(img, qtype)
        ctx = (nx, ny, qtype, kind)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=str(ctx))
    assert ncases == 32


# -------------------------------------------------------- MTF / autostretch

def test_mtf_autostretch_vs_c():
    """findMidtonesBalance + apply_mtf_to_fits vs the compiled reference
    blocks extracted from gui/histogram.c (the STF autostretch math)."""
    from siriltpu.ops.histogram_ops import apply_mtf, find_midtones_balance

    r = Reader(os.path.join(GOLDEN_DIR, "c_mtf.bin"))
    ncases = 0
    while not r.eof():
        nx = r.take("H")
        ny = r.take("H")
        nchan = r.take("B")
        kind = r.take("B")
        img = r.take_u16s(nchan * nx * ny).reshape(nchan, ny, nx)
        m, lo, hi = r.take("ddd")
        out = r.take_u16s(nchan * nx * ny).reshape(nchan, ny, nx)
        ncases += 1
        ctx = (nchan, kind)
        gm, glo, ghi = find_midtones_balance(img)
        np.testing.assert_allclose(gm, m, rtol=1e-12, atol=0, err_msg=str(ctx))
        np.testing.assert_allclose(glo, lo, rtol=1e-12, atol=1e-15,
                                   err_msg=str(ctx))
        np.testing.assert_allclose(ghi, hi, rtol=1e-12, atol=0,
                                   err_msg=str(ctx))
        # apply with the C's own (m, lo, hi) so LUT parity is bit-exact even
        # if the balance differed in the last ulp
        norm = 255.0 if img.max() <= 255 else 65535.0
        gout = np.stack([apply_mtf(img[c], m, lo, hi, norm=norm)
                         for c in range(nchan)])
        np.testing.assert_array_equal(gout.astype(np.uint16), out,
                                      err_msg=str(ctx))
    assert ncases == 6


# ---------------------------------------------------------------- photometry

def test_photometry_vs_c():
    """Hampel robustmean + aperture photometry vs the compiled reference
    photometry.c block."""
    from siriltpu.ops.photometry import PhotConfig, get_photometry, robustmean

    r = Reader(os.path.join(GOLDEN_DIR, "c_photometry.bin"))
    # part A: robustmean over 4 sizes x 3 kinds x 3 reps
    for _ in range(36):
        n = r.take("i")
        kind = r.take("B")
        xs = np.asarray(r.take("d" * n)) if n > 1 else np.asarray([r.take("d")])
        ret = r.take("i")
        mean = r.take("d")
        stdev = r.take("d")
        gmean, gstdev, gret = robustmean(xs)
        ctx = (n, kind)
        assert gret == ret, ctx
        np.testing.assert_allclose(gmean, mean, rtol=1e-10, atol=1e-10,
                                   err_msg=str(ctx))
        np.testing.assert_allclose(gstdev, stdev, rtol=1e-8, atol=1e-10,
                                   err_msg=str(ctx))
    # part B: getPhotometryData over 6 synthetic stars
    nb = 0
    while not r.eof():
        w = r.take("i")
        h = r.take("i")
        x0, y0, sx = r.take("ddd")
        z = np.asarray(r.take("d" * (w * h))).reshape(h, w)
        ok = r.take("B")
        nb += 1
        got = get_photometry(z, x0, y0, sx, PhotConfig())
        if not ok:
            assert got is None, nb
            continue
        mag, s_mag = r.take("dd")
        assert got is not None, nb
        np.testing.assert_allclose(got.mag, mag, rtol=1e-11, err_msg=str(nb))
        np.testing.assert_allclose(got.s_mag, s_mag, rtol=1e-9,
                                   err_msg=str(nb))
    assert nb == 6


# -------------------------------------------------------------------- colors

def test_colors_vs_c():
    """Colorspace conversions + SCNR + saturation + background
    neutralization vs the compiled reference colors.c blocks."""
    from siriltpu.core.frame import Rect
    from siriltpu.ops.colors import (background_neutralize,
                                     enhance_saturation, hsl_to_rgb,
                                     hsv_to_rgb, lab_to_xyz, rgb_to_hsl,
                                     rgb_to_hsv, rgb_to_xyz, scnr,
                                     xyz_to_lab, xyz_to_rgb)

    r = Reader(os.path.join(GOLDEN_DIR, "c_colors.bin"))

    def close(got, want, ctx, tol=1e-13):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=str(ctx))

    # part A: 300 conversion fixtures
    for i in range(300):
        rr, gg, bb = r.take("ddd")
        close(rgb_to_hsl(rr, gg, bb), r.take("ddd"), ("hsl", i))
        h, s, l = rgb_to_hsl(rr, gg, bb)
        close(hsl_to_rgb(h, s, l), r.take("ddd"), ("hsl_rt", i))
        close(rgb_to_hsv(rr, gg, bb), r.take("ddd"), ("hsv", i))
        h, s, v = rgb_to_hsv(rr, gg, bb)
        close(hsv_to_rgb(h, s, v), r.take("ddd"), ("hsv_rt", i))
        x, y, z = r.take("ddd")
        close(rgb_to_xyz(rr, gg, bb), (x, y, z), ("xyz", i))
        L, A, B = r.take("ddd")
        close(xyz_to_lab(x, y, z), (L, A, B), ("lab", i))
        x2, y2, z2 = r.take("ddd")
        close(lab_to_xyz(L, A, B), (x2, y2, z2), ("lab_rt", i))
        close(xyz_to_rgb(x2, y2, z2), r.take("ddd"), ("xyz_rt", i))

    # part B: SCNR 4 types x preserve
    for _ in range(8):
        nx = r.take("H"); ny = r.take("H")
        typ = r.take("B"); preserve = r.take("B")
        amount = r.take("d")
        img = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        out = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        got = scnr(img, typ, amount, preserve_lightness=bool(preserve))
        np.testing.assert_array_equal(got, out,
                                      err_msg=f"scnr {typ} {preserve}")

    # part C: saturation enhancement
    for i in range(4):
        nx = r.take("H"); ny = r.take("H")
        hmin, hmax = r.take("dd")
        preserve = r.take("B")
        img = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        out = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        got = enhance_saturation(img, 0.4, h_min=hmin, h_max=hmax,
                                 preserve_background=bool(preserve))
        np.testing.assert_array_equal(got, out, err_msg=f"satu {i}")

    # part D: background neutralization
    nd = 0
    while not r.eof():
        nx = r.take("H"); ny = r.take("H")
        sx, sy, sw, sh = r.take("hhhh")
        img = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        out = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        got = background_neutralize(img, Rect(sx, sy, sw, sh))
        np.testing.assert_array_equal(got, out, err_msg=f"neutralize {nd}")
        nd += 1
    assert nd == 3


# ------------------------------------------------------------------ cosmetic

def test_cosmetic_vs_c():
    """Deviant-pixel detection + cosmetic correction vs the compiled
    reference cosmetic_correction.c block."""
    from siriltpu.ops.cosmetic import (COLD_PIXEL, HOT_PIXEL,
                                       cosmetic_correction,
                                       find_deviant_pixels)

    r = Reader(os.path.join(GOLDEN_DIR, "c_cosmetic.bin"))
    ncases = 0
    while not r.eof():
        nx = r.take("H"); ny = r.take("H")
        sig0, sig1 = r.take("dd")
        img = r.take_u16s(nx * ny).reshape(ny, nx)
        icold = r.take("q"); ihot = r.take("q")
        ndev = r.take("i")
        cdevs = []
        for _ in range(ndev):
            x, y = r.take("dd")
            t = r.take("B")
            cdevs.append((int(x), int(y), t))
        ncases += 1
        ctx = (sig0, sig1, ncases)
        devs, gicold, gihot = find_deviant_pixels(img, (sig0, sig1))
        assert (gicold, gihot) == (icold, ihot), ctx
        assert len(devs) == ndev, ctx
        for k, d in enumerate(devs):
            want_t = HOT_PIXEL if cdevs[k][2] == 1 else COLD_PIXEL
            assert (d.x, d.y, d.type) == (cdevs[k][0], cdevs[k][1],
                                          want_t), (ctx, k)
        for cfa in (False, True):
            out = r.take_u16s(nx * ny).reshape(ny, nx)
            got = cosmetic_correction(img, devs, is_cfa=cfa)
            np.testing.assert_array_equal(got, out, err_msg=str((ctx, cfa)))
    assert ncases == 8


# ------------------------------------------------------------------ wavelets

def test_wavelets_vs_c(tmp_path):
    """À-trous transform, plane extraction, weighted reconstruction and
    .wave persistence vs the compiled pave.c/transform.c/reconstr.c/
    io_wave.c.

    The float planes are compared with a small tolerance: the reference
    smooths with one 2-D pass accumulated in double and rounded once to
    float, siriltpu with two separable float32 passes (the separable
    device form) — identical taps and borders, different FP summation order.
    WORD outputs must agree within 1 LSB with only rare (<1%) flips."""
    from siriltpu.ops import wave_io
    from siriltpu.ops.wavelets import atrous_reconstruct, atrous_transform
    from siriltpu.utils.rounding import np_round_to_word

    def c_reget(p):
        p = np.asarray(p, np.float64)
        mx = np.float32(p.astype(np.float32).max())
        ratio = 65535.0 / float(mx) if mx > 65535.0 else 1.0
        return np_round_to_word(p * ratio)

    def word_close(got, want, ctx):
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1, (ctx, d.max())
        assert (d != 0).mean() < 0.01, (ctx, (d != 0).mean())

    r = Reader(os.path.join(GOLDEN_DIR, "c_wavelets.bin"))
    assert r.take("i") == 440   # sizeof(wave_transf_des), LP64
    assert r.take("i") == 100   # offsetof(Nbr_Ligne) == MAX_SIZE_NAME_IMAG

    ncases = 0
    while r.off < len(r.buf) - 63 * 4 - 63 * 2:
        nl = r.take("H"); nc = r.take("H")
        kind = r.take("B"); nplanes = r.take("B")
        img = r.take_u16s(nl * nc).reshape(nl, nc)
        want_planes = r.take_f32s(nplanes * nl * nc).reshape(nplanes, nl, nc)
        got_planes = np.asarray(atrous_transform(img, nplanes, kind))
        np.testing.assert_allclose(got_planes, want_planes, atol=0.5,
                                   rtol=1e-5, err_msg=str((nl, nc, kind)))
        # get_wavelet_layers: per-plane extraction -> WORD
        for plan in range(nplanes):
            want_w = r.take_u16s(nl * nc).reshape(nl, nc)
            word_close(c_reget(got_planes[plan]), want_w,
                       ("plane", nl, nc, kind, plan))
        # wrecons: weighted reconstruction -> WORD
        coef = r.take_f32s(nplanes)
        want_w = r.take_u16s(nl * nc).reshape(nl, nc)
        rec = np.asarray(atrous_reconstruct(got_planes, coef))
        word_close(c_reget(rec), want_w, ("recon", nl, nc, kind))
        # .wave bytes written by the reference (pointer fields zeroed)
        fsize = r.take("q")
        cbytes = r.take_bytes(fsize)
        p = tmp_path / f"case{ncases}.wave"
        p.write_bytes(cbytes)
        planes_rd, kind_rd = wave_io.wave_read(str(p))
        assert kind_rd == kind
        np.testing.assert_array_equal(planes_rd, want_planes)
        # and siriltpu's writer reproduces those bytes exactly
        q = tmp_path / f"case{ncases}_py.wave"
        wave_io.wave_write(str(q), want_planes, kind, name="")
        assert q.read_bytes() == cbytes, "wave_write not byte-identical"
        ncases += 1
    assert ncases == 6

    # reget_rawdata rescale path (>65535 and negative floats)
    im = r.take_f32s(63)
    want = r.take_u16s(63)
    np.testing.assert_array_equal(c_reget(im), want)
    assert r.eof()


# --------------------------------------------------------------- image ops

def test_imops_vs_c():
    """soper/imoper/fdiv/addmax, entropy, loglut, contrast, fill, off,
    BandingEngine and backgroundnoise vs the compiled core/siril.c
    blocks."""
    from siriltpu.core.frame import Rect
    from siriltpu.ops.imops import (addmax, banding_reduction,
                                    background_noise, contrast, entropy,
                                    fdiv, fill, imoper, loglut, off, soper)

    r = Reader(os.path.join(GOLDEN_DIR, "c_imops.bin"))
    nx, ny = 31, 17

    # part A: arithmetic ops
    for rep in range(2):
        for li in range(2):
            nl = 3 if li else 1
            n = nx * ny * nl
            nlay = r.take("B")
            assert nlay == nl
            scalar = r.take("d")
            coef = r.take_f32s(1)[0]
            a = r.take_u16s(n).reshape(nl, ny, nx)
            b = r.take_u16s(n).reshape(nl, ny, nx)
            for op in ("add", "sub", "mul", "div"):
                want = r.take_u16s(n).reshape(nl, ny, nx)
                np.testing.assert_array_equal(
                    soper(a, scalar, op), want, err_msg=f"soper {op} {rep}")
                want = r.take_u16s(n).reshape(nl, ny, nx)
                np.testing.assert_array_equal(
                    imoper(a, b, op), want, err_msg=f"imoper {op} {rep}")
            want_ret = r.take("B")
            want = r.take_u16s(n).reshape(nl, ny, nx)
            got, ret = fdiv(a, b, float(coef))
            assert ret == want_ret
            np.testing.assert_array_equal(got, want, err_msg=f"fdiv {rep}")
            want = r.take_u16s(n).reshape(nl, ny, nx)
            np.testing.assert_array_equal(addmax(a, b), want,
                                          err_msg=f"addmax {rep}")

    # part B: entropy (plain / selection / stats threshold)
    class _St:
        pass
    img = r.take_u16s(nx * ny).reshape(ny, nx)
    np.testing.assert_allclose(entropy(img), r.take("d"), rtol=1e-12)
    np.testing.assert_allclose(entropy(img, rect=Rect(5, 3, 20, 11)),
                               r.take("d"), rtol=1e-12)
    st = _St()
    st.median = r.take("d")
    st.sigma = r.take("d")
    np.testing.assert_allclose(entropy(img, stats=st), r.take("d"),
                               rtol=1e-12)

    # part C: loglut LOG then EXP round-trip
    img = r.take_u16s(nx * ny).reshape(ny, nx)
    logw = r.take_u16s(nx * ny).reshape(ny, nx)
    np.testing.assert_array_equal(loglut(img), logw, err_msg="loglut LOG")
    expw = r.take_u16s(nx * ny).reshape(ny, nx)
    np.testing.assert_array_equal(loglut(logw, inverted=True), expw,
                                  err_msg="loglut EXP")

    # part D: contrast — empty selection (full-image mean) then a rect
    from siriltpu.ops.stats import STATS_BASIC, statistics
    img = r.take_u16s(nx * ny).reshape(ny, nx)
    stf = statistics(img, option=STATS_BASIC, nullcheck=True)
    np.testing.assert_allclose(contrast(img, stf.mean), r.take("d"),
                               rtol=1e-12)
    sts = statistics(img, selection=Rect(4, 2, 12, 9), option=STATS_BASIC,
                     nullcheck=True)
    np.testing.assert_allclose(contrast(img, sts.mean), r.take("d"),
                               rtol=1e-12)

    # part E: fill rect, off +/-
    img = r.take_u16s(nx * ny).reshape(1, ny, nx)
    np.testing.assert_array_equal(
        fill(img, 4242, Rect(7, 2, 13, 8)),
        r.take_u16s(nx * ny).reshape(1, ny, nx), err_msg="fill")
    np.testing.assert_array_equal(
        off(img, 20000), r.take_u16s(nx * ny).reshape(1, ny, nx),
        err_msg="off+")
    np.testing.assert_array_equal(
        off(img, -20000), r.take_u16s(nx * ny).reshape(1, ny, nx),
        err_msg="off-")

    # part F: BandingEngine
    bx, by = 64, 48
    for ci in range(4):
        img = r.take_u16s(bx * by).reshape(1, by, bx)
        sigma = r.take("d")
        amount = r.take("d")
        protect = bool(r.take("B"))
        want = r.take_u16s(bx * by).reshape(1, by, bx)
        got = banding_reduction(img, sigma, amount,
                                protect_highlights=protect)
        np.testing.assert_array_equal(got, want, err_msg=f"banding {ci}")

    # part H: threshlo / threshhi / nozero
    from siriltpu.ops.imops import nozero, shift_image, threshhi, threshlo
    img = r.take_u16s(nx * ny).reshape(1, ny, nx)
    np.testing.assert_array_equal(
        threshlo(img, 12000), r.take_u16s(nx * ny).reshape(1, ny, nx))
    np.testing.assert_array_equal(
        threshhi(img, 50000), r.take_u16s(nx * ny).reshape(1, ny, nx))
    np.testing.assert_array_equal(
        nozero(img, 777), r.take_u16s(nx * ny).reshape(1, ny, nx))

    # part I: shift() — the ii > 0 source-skip quirk + zero fill
    img = r.take_u16s(nx * ny).reshape(1, ny, nx)
    for _ in range(4):
        sx = r.take("H"); sx = sx - 65536 if sx >= 32768 else sx
        sy = r.take("H"); sy = sy - 65536 if sy >= 32768 else sy
        want = r.take_u16s(nx * ny).reshape(1, ny, nx)
        got = shift_image(img, int(sx), int(sy))
        np.testing.assert_array_equal(got, want, err_msg=f"shift {sx},{sy}")

    # part G: backgroundnoise
    bx, by = 96, 80
    img = r.take_u16s(bx * by).reshape(1, by, bx)
    want = r.take("d")
    got = background_noise(img)[0]
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert r.eof()


# -------------------------------------------------------------- background

def test_background_vs_c():
    """Box-grid sample construction + polynomial background fit vs the
    compiled gradient.c. Sample positions/values must match exactly
    (the box grid arithmetic, in-place sigma-clip median replacement and
    deviation rejection are all integer/double-deterministic); the
    fitted WORD image may differ by 1 LSB on truncation knife-edges
    (minigsl solves the LSQ by column-scaled QR, GSL by balanced SVD —
    same unique minimizer to ~1e-12)."""
    from siriltpu.ops.background import (BackgroundParams,
                                         build_background_samples,
                                         compute_background)

    r = Reader(os.path.join(GOLDEN_DIR, "c_gradient.bin"))
    ncases = 0
    while not r.eof():
        w = r.take("H"); h = r.take("H"); box = r.take("H")
        order = r.take("B") + 1            # POLY_1 enum value is 0
        bpr = r.take("H"); bpc = r.take("H")
        img = r.take_u16s(w * h).reshape(h, w)
        n = bpr * bpc
        cx = np.empty(n); cy = np.empty(n); cv = np.empty(n)
        for i in range(n):
            cx[i] = r.take("d"); cy[i] = r.take("d"); cv[i] = r.take("d")
        want_img = r.take_u16s(w * h).reshape(h, w)
        p = BackgroundParams(order=order, box=box, boxes_per_row=bpr,
                             boxes_per_col=bpc, tolerance=2.0,
                             deviation=1.0, unbalance=0.8)
        cols, rows, vals = build_background_samples(
            img.astype(np.float64), p)
        midbox = box * 0.5
        # com.grad centres: x = col + midbox, y = height - row + midbox
        np.testing.assert_allclose(cols + midbox, cx, rtol=0, atol=0,
                                   err_msg=f"centres x case {ncases}")
        np.testing.assert_allclose(h - rows + midbox, cy, rtol=0, atol=0,
                                   err_msg=f"centres y case {ncases}")
        np.testing.assert_allclose(vals, cv, rtol=0, atol=0,
                                   err_msg=f"box values case {ncases}")
        model = compute_background(img, p)
        got = (model.astype(np.int64).astype(np.int32)
               & 0xFFFF).astype(np.uint16)
        d = np.abs(got.astype(int) - want_img.astype(int))
        assert d.max() <= 1, (ncases, d.max())
        assert (d != 0).mean() < 0.01, (ncases, (d != 0).mean())
        ncases += 1
    assert ncases == 3


# --------------------------------------------------------------------- psf

def test_psf_vs_c():
    """Gaussian PSF fits vs the compiled PSF.c driven through its real
    GSL entry points (psf_global_minimisation incl. the angle refit and
    sx>=sy fold). The harness verifies each fixture converged, so both
    solvers sit at the same minimum; the comparison tolerance covers the
    float32 device fit vs the C's float64."""
    from siriltpu.ops.psf import fit_psf_single

    r = Reader(os.path.join(GOLDEN_DIR, "c_psf.bin"))
    fields = ("B", "A", "x0", "y0", "sx", "sy", "fwhmx", "fwhmy",
              "angle", "mag", "rmse")
    ncases = 0
    while not r.eof():
        bs = r.take("H")
        fit_angle = bool(r.take("B"))
        img = r.take_u16s(bs * bs).reshape(bs, bs)
        bg = r.take("d")
        want = dict(zip(fields, (r.take("d") for _ in fields)))
        got = fit_psf_single(img, bg, fit_angle=fit_angle)
        assert got is not None, ncases
        for k in ("x0", "y0"):
            assert abs(got[k] - want[k]) < 0.02, (ncases, k, got[k], want[k])
        for k in ("B", "A", "sx", "sy", "fwhmx", "fwhmy"):
            assert abs(got[k] - want[k]) < 0.015 * max(abs(want[k]), 1e-6), (
                ncases, k, got[k], want[k])
        assert abs(got["mag"] - want["mag"]) < 0.02, (ncases, got, want)
        if fit_angle and abs(want["angle"]) > 1e-6:
            assert abs(got["angle"] - want["angle"]) < 1.5, (ncases, got,
                                                             want)
        ncases += 1
    assert ncases == 5


# ---------------------------------------------------------------- starfind

def test_starfind_vs_c():
    """Full peaker vs the compiled star_finder.c (threshold, wavelet
    prefilter, 8-neighbor tie rules, PSF fits, is_star gates, mag sort).
    The reference fills the fit box TRANSPOSED (documented divergence:
    PARITY.md #2), which swaps its sx/sy and can flip the roundness gate
    for the most elongated stars — so the star SETS are matched by
    position with a small allowance for gate flips instead of demanding
    identical lists."""
    from siriltpu.ops.starfind import StarFinderParams, peaker

    r = Reader(os.path.join(GOLDEN_DIR, "c_starfind.bin"))
    w = r.take("H"); h = r.take("H"); radius = r.take("H")
    sigma = r.take("d"); roundness = r.take("d")
    img = r.take_u16s(w * h).reshape(h, w)
    n = r.take("i")
    cstars = []
    for _ in range(n):
        xpos = r.take("d"); ypos = r.take("d")
        vals = [r.take("d") for _ in range(11)]
        cstars.append((xpos, ypos, vals))
    assert r.eof()
    assert n >= 15

    got = peaker(img, params=StarFinderParams(radius=radius, sigma=sigma,
                                              roundness=roundness))
    # The transposed box swaps the SUB-PIXEL offsets between the axes:
    # C.x = X + fy, C.y = Y + fx while siriltpu reports X + fx, Y + fy.
    # The coordinate SUM is exactly invariant under that swap, so match
    # within the <=sqrt(2) px swap radius and pin the sum tightly.
    matched = 0
    for cx, cy, cv in cstars:
        best = None
        for s in got:
            d = ((s.xpos - cx) ** 2 + (s.ypos - cy) ** 2) ** 0.5
            if best is None or d < best[0]:
                best = (d, s)
        if best and best[0] < 1.6:
            matched += 1
            s = best[1]
            assert abs((s.xpos + s.ypos) - (cx + cy)) < 0.06, (cx, cy, s)
            assert abs((s.xpos - cx) + (s.ypos - cy)) < 0.06, (cx, cy, s)
            assert abs(s.mag - cv[9]) < 0.05, (cx, cy, s.mag, cv[9])
            assert abs(s.B - cv[0]) < 0.01, (cx, cy)
            assert abs(s.A - cv[1]) < 0.03 * max(cv[1], 1e-6), (cx, cy)
            # sx/sy come from the transposed fit then the sx>=sy fold:
            # the {sx, sy} SET matches
            assert abs(max(s.sx, s.sy) - max(cv[4], cv[5])) < 0.05 * max(
                cv[4], 1.0), (cx, cy, s)
            assert abs(min(s.sx, s.sy) - min(cv[4], cv[5])) < 0.05 * max(
                cv[5], 1.0), (cx, cy, s)
    # every C star recovered, modulo a couple of roundness-gate flips
    # from the documented transposed-box divergence (PARITY.md #2)
    assert matched >= n - 2, (matched, n, len(got))
    assert abs(len(got) - n) <= 3, (len(got), n)


# ------------------------------------------------------------ star matching

def test_star_match_vs_c():
    """Triangle-space star matching vs the compiled atpmatch stack
    (match.c new_star_match driving atFindTrans → atApplyTrans →
    atMatchLists → atRecalcTrans, with cvCalculH stubbed to capture the
    final matched pairs). The array-program matcher must produce the
    same correspondence set on rotated/scaled/polluted star lists."""
    from siriltpu.registration.matching import new_star_match

    r = Reader(os.path.join(GOLDEN_DIR, "c_match.bin"))
    ncases = 0
    while not r.eof():
        n = r.take("H")
        ang = r.take("d"); sc = r.take("d")
        tx = r.take("d"); ty = r.take("d")
        A = np.array([[r.take("d"), r.take("d"), r.take("d")]
                      for _ in range(n)])
        B = np.array([[r.take("d"), r.take("d"), r.take("d")]
                      for _ in range(n)])
        m = r.take("i")
        cpairs = [(r.take("d"), r.take("d"), r.take("d"), r.take("d"))
                  for _ in range(m)]
        res = new_star_match(A[:, :2], B[:, :2])
        assert res is not None, ncases
        gi, gr, trans = res
        # C pair (a -> b): our matcher must pair the same a with the
        # same b (coordinates are shared exactly with the golden input)
        ours = {}
        for k in range(gi.shape[0]):
            ours[(round(gi[k, 0], 9), round(gi[k, 1], 9))] = (
                round(gr[k, 0], 9), round(gr[k, 1], 9))
        agree = 0
        for ax, ay, bx, by in cpairs:
            got = ours.get((round(ax, 9), round(ay, 9)))
            if got == (round(bx, 9), round(by, 9)):
                agree += 1
        assert agree >= m - 2, (ncases, agree, m, gi.shape[0])
        assert abs(gi.shape[0] - m) <= 2, (ncases, gi.shape[0], m)
        ncases += 1
    assert ncases == 3


# --------------------------------------------------------------------- ser

def test_ser_vs_c(tmp_path):
    """SER container I/O vs the compiled ser.c: write-path bytes,
    header parse, full-frame reads (mono/RGB/Bayer+VNG debayer), the
    inverted-endianness quirk, partial region reads (incl. the Bayer
    demosaic-window path), and truncated-file repair."""
    from siriltpu.core.frame import Frame, Rect
    from siriltpu.io.ser import SER_HEADER_LEN, SerFile

    r = Reader(os.path.join(GOLDEN_DIR, "c_ser.bin"))
    w, h = 40, 30
    npix = w * h

    # ---- part A: mono create/write/read ----
    inputs = [r.take_u16s(npix).reshape(h, w) for _ in range(3)]
    fsize = r.take("q")
    cbytes = r.take_bytes(fsize)
    p = tmp_path / "mono.ser"
    sw = SerFile.create(str(p), width=w, height=h, color_id=0)
    for img in inputs:
        sw.write_frame(Frame(img.reshape(1, h, w).copy()))
    sw.write_and_close()
    assert p.read_bytes() == cbytes, "mono SER bytes differ from C writer"
    hdr = [r.take("i") for _ in range(6)]
    sr = SerFile.open(str(p))
    assert [sr.header.color_id, sr.header.little_endian, sr.header.width,
            sr.header.height, sr.header.bit_pixel_depth,
            sr.frame_count] == hdr
    for k in range(3):
        want = r.take_u16s(npix).reshape(h, w)
        got = sr.read_frame(k).data[0]
        np.testing.assert_array_equal(got, want, err_msg=f"mono frame {k}")
    # full-width row block: the only shape the reference ever passes
    # (its mono/RGB partial read is a contiguous run, see PARITY.md)
    want = r.take_u16s(40 * 11).reshape(11, 40)
    got = sr.read_opened_partial(0, 1, Rect(0, 5, 40, 11))
    np.testing.assert_array_equal(got, want, err_msg="mono partial")

    # ---- part B: RGB (SER v3) ----
    inputs = [r.take_u16s(npix * 3).reshape(3, h, w) for _ in range(2)]
    fsize = r.take("q")
    cbytes = r.take_bytes(fsize)
    p = tmp_path / "rgb.ser"
    sw = SerFile.create(str(p), width=w, height=h, color_id=100)
    for img in inputs:
        sw.write_frame(Frame(img.copy()))
    sw.write_and_close()
    assert p.read_bytes() == cbytes, "RGB SER bytes differ from C writer"
    assert r.take("i") == 100
    sr = SerFile.open(str(p))
    for k in range(2):
        want = r.take_u16s(npix * 3).reshape(3, h, w)
        got = sr.read_frame(k).data
        np.testing.assert_array_equal(got, want, err_msg=f"rgb frame {k}")
    for layer in range(3):
        want = r.take_u16s(40 * 9).reshape(9, 40)
        got = sr.read_opened_partial(layer, 0, Rect(0, 2, 40, 9))
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"rgb partial L{layer}")

    # ---- part C: Bayer RGGB, big-endian data (inverted flag), VNG ----
    cfas = [r.take_u16s(npix).reshape(h, w) for _ in range(2)]
    p = tmp_path / "bayer.ser"
    import struct as _s
    hdr = bytearray(SER_HEADER_LEN)
    hdr[:14] = b"LUCAM-RECORDER"
    _s.pack_into("<iiiiii", hdr, 18, 8, 1, w, h, 16, 2)
    with open(p, "wb") as fo:
        fo.write(hdr)
        for cfa in cfas:
            fo.write(cfa.astype(">u2").tobytes())
    sr = SerFile.open(str(p))
    want = r.take_u16s(npix * 3).reshape(3, h, w)
    got = sr.read_frame(0, debayer=True, bayer_method="vng").data
    np.testing.assert_array_equal(got, want, err_msg="bayer VNG frame")
    for layer in range(3):
        # full-width row block (the C's debayer-area read is contiguous)
        want = r.take_u16s(40 * 10).reshape(10, 40)
        got = sr.read_opened_partial(layer, 1, Rect(0, 6, 40, 10),
                                     debayer=True, bayer_method="vng")
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"bayer partial L{layer}")
    want = r.take_u16s(npix).reshape(h, w)
    got = sr.read_frame(0).data[0]
    np.testing.assert_array_equal(got, want, err_msg="bayer-as-mono")

    # crashed-capture repair: truncated file with a ZEROED header count
    # (the only case the reference repairs, ser.c:337-344)
    with open(p, "r+b") as fo:
        fo.truncate(SER_HEADER_LEN + npix * 2 + npix)
        fo.seek(38)
        fo.write(b"\x00\x00\x00\x00")
    sr = SerFile.open(str(p))
    assert sr.frame_count == r.take("i")
    fsize = r.take("q")
    cbytes = r.take_bytes(fsize)
    assert p.read_bytes() == cbytes, "repaired SER bytes differ"
    assert r.eof()


# ----------------------------------------------------------------- seqfile

def test_seqfile_vs_c(tmp_path):
    """.seq sidecar vs the compiled seqfile.c: our writer's text must be
    byte-identical, and our parser must extract the same fields the
    compiled readseqfile does (incl. %g stats and negative shifts)."""
    from siriltpu.core.frame import ImStats, ImgParam, RegData
    from siriltpu.io.seqfile import read_seqfile, write_seqfile
    from siriltpu.io.sequence import Sequence

    r = Reader(os.path.join(GOLDEN_DIR, "c_seqfile.bin"))
    fsize = r.take("q")
    ctext = r.take_bytes(fsize)

    # reconstruct the same sequence and compare writer output bytes
    seq = Sequence(seqname="/tmp/ph_seqtest", beg=1, number=5, selnum=4,
                   fixed=5, reference_image=2, nb_layers=1)
    for i in range(5):
        p = ImgParam(filenum=i + 1, incl=(i != 3))
        if i % 2 == 0:
            p.stats = ImStats(
                mean=1234.5678901 + i, median=1200.0 + i,
                sigma=56.789 + i, avgdev=43.21 + i, mad=40.5 + i,
                sqrtbwmv=41.25 + i, location=0.0183105 + i * 1e-4,
                scale=0.00087 + i * 1e-5, min=12.0, max=65535.0)
        seq.imgparam.append(p)
    seq.regparam[0] = [
        RegData(shiftx=(i - 2) * 3, shifty=2 - i, rot_centre_x=512.25,
                rot_centre_y=384.75, angle=0.125 * i, fwhm=3.5 + 0.25 * i,
                quality=0.912345678 - 0.01 * i)
        for i in range(5)]
    out = tmp_path / "ph_seqtest.seq"
    seq2 = Sequence(**{**seq.__dict__})
    seq2.seqname = "ph_seqtest"
    write_seqfile(seq2, str(tmp_path))
    mine = out.read_bytes().replace(b"S 'ph_seqtest'",
                                    b"S '/tmp/ph_seqtest'")
    assert mine == ctext, "seqfile text differs from the C writer"

    # parse the C-written text with our reader, compare with what the
    # compiled readseqfile itself extracted
    cseq = tmp_path / "cwritten.seq"
    cseq.write_bytes(ctext)
    got = read_seqfile(str(cseq))
    assert [got.beg, got.number, got.selnum, got.fixed,
            got.reference_image, got.nb_layers] == [
        r.take("i") for _ in range(6)]
    cend = r.take("i")
    assert got.imgparam[-1].filenum == cend
    for i in range(5):
        assert got.imgparam[i].filenum == r.take("i")
        assert int(got.imgparam[i].incl) == r.take("i")
        has = r.take("B")
        assert (got.imgparam[i].stats is not None) == bool(has)
        if has:
            s = got.imgparam[i].stats
            assert s.mean == r.take("d")
            assert s.median == r.take("d")
            assert s.sigma == r.take("d")
            assert s.location == r.take("d")
            assert s.scale == r.take("d")
    for i in range(5):
        g = got.regparam[0][i]
        assert g.shiftx == r.take("i")
        assert g.shifty == r.take("i")
        assert g.angle == pytest.approx(r.take("d"), abs=1e-7)
        assert g.fwhm == pytest.approx(r.take("d"), abs=1e-6)
        assert g.quality == pytest.approx(r.take("d"), rel=1e-9)
    assert r.eof()


# ------------------------------------------------------------------- formats
def _blob(r):
    return r.take_bytes(r.take("q"))


def test_c_formats_golden(tmp_path):
    """Internal image formats vs the compiled reference TU
    (image_formats_internal.c, compiled whole): readbmp's byte-10 offset
    and palette-skip quirks, savebmp's display-buffer BGR serialization,
    saveppm/savepgm headers, import_pnm_to_fits strictness, readpic."""
    from siriltpu.core.frame import Frame
    from siriltpu.io.formats import (load_bmp, load_pic, load_pnm,
                                     save_pnm, write_bmp24)

    r = Reader(os.path.join(GOLDEN_DIR, "c_formats.bin"))

    # part A: readbmp (8/24/32-bit, 32-bit alpha-first)
    for case in range(4):
        raw = _blob(r)
        p = tmp_path / f"a{case}.bmp"
        p.write_bytes(raw)
        rv, rx, ry, nchan, bitpix = (r.take("i") for _ in range(5))
        planes = r.take_u16s(rx * ry * nchan)
        got = load_bmp(str(p))
        assert got.nlayers == nchan
        assert (got.rx, got.ry) == (rx, ry)
        np.testing.assert_array_equal(got.data.ravel(), planes)
        # readbmp returns the file's plane count (4 for 32-bit BGRA)
        assert nchan == (1 if rv == 1 else 3) and bitpix == 8  # BYTE_IMG

    # part B: savebmp from display graybufs (4-byte stride, rows
    # written bottom-up, pad byte '0')
    for case in range(2):
        w, h, nchan = r.take("i"), r.take("i"), r.take("i")
        bufs = [np.frombuffer(_blob(r), np.uint8) for _ in range(3)]
        cfile = _blob(r)
        r8, g8, b8 = (b[::4].reshape(h, w) for b in bufs)
        if nchan == 1:
            g8 = b8 = r8     # savebmp:186-189 replicates the red buffer
        p = tmp_path / f"b{case}.bmp"
        write_bmp24(str(p), r8, g8, b8)
        assert p.read_bytes() == cfile

    # part C: saveppm (RGB) and savepgm (mono)
    w, h = r.take("i"), r.take("i")
    img = r.take_u16s(w * h * 3).reshape(3, h, w)
    cfile = _blob(r)
    p = tmp_path / "c.ppm"
    # C fits planes are bottom-up rows, identical to Frame order
    save_pnm(str(p), Frame(img))
    assert p.read_bytes() == cfile
    w, h = r.take("i"), r.take("i")
    img = r.take_u16s(w * h).reshape(1, h, w)
    cfile = _blob(r)
    p = tmp_path / "c.pgm"
    save_pnm(str(p), Frame(img))
    assert p.read_bytes() == cfile

    # part D: import_pnm_to_fits (maxval 255/32767/65535 + rejection)
    for case in range(6):
        raw = _blob(r)
        p = tmp_path / f"d{case}.pnm"
        p.write_bytes(raw)
        rv = r.take("i")
        if rv < 0:
            with pytest.raises(ValueError):
                load_pnm(str(p))
            continue
        rx, ry, nchan, bitpix = (r.take("i") for _ in range(4))
        planes = r.take_u16s(rx * ry * nchan)
        got = load_pnm(str(p))
        assert got.nlayers == nchan and (got.rx, got.ry) == (rx, ry)
        np.testing.assert_array_equal(got.data.ravel(), planes)

    # part E: readpic
    for case in range(2):
        raw = _blob(r)
        p = tmp_path / f"e{case}.pic"
        p.write_bytes(raw)
        rv, rx, ry, binx, biny = (r.take("i") for _ in range(5))
        hi, lo = r.take("H"), r.take("H")
        planes = r.take_u16s(rx * ry * rv)
        got = load_pic(str(p))
        assert got.nlayers == rv and (got.rx, got.ry) == (rx, ry)
        assert (got.meta["binning_x"], got.meta["binning_y"]) == (binx, biny)
        assert (got.meta["hi"], got.meta["lo"]) == (hi, lo)
        np.testing.assert_array_equal(got.data.ravel(), planes)
    assert r.eof()


def test_linearfit_hybrid_bitexact_vs_c():
    """The LINEARFIT hybrid (f32 kernel + f64 oracle re-run of
    knife-edge pixels) is bit-exact vs the compiled C on every golden
    vector — means AND rejection counters, no tolerance (the plain f32
    kernel's double-rounding knife-edges, PARITY.md 7a, are exactly the
    pixels the hybrid re-runs)."""
    from siriltpu.ops.rejection import linearfit_hybrid_block

    recs = [r for r in _read_rejection() if REJ_NAMES[r[0]] == "linearfit"]
    assert len(recs) > 300
    groups = {}
    for t, kind, n, sig0, sig1, vec, mean, rej0, rej1 in recs:
        groups.setdefault((n, sig0, sig1), []).append((vec, mean, rej0, rej1))
    for (n, sig0, sig1), items in groups.items():
        vals = np.stack([it[0] for it in items], axis=1)
        mean, rl, rh = linearfit_hybrid_block(vals, (sig0, sig1))
        np.testing.assert_array_equal(
            mean, np.array([it[1] for it in items], np.uint16))
        np.testing.assert_array_equal(
            rl, np.array([it[2] for it in items], np.int32))
        np.testing.assert_array_equal(
            rh, np.array([it[3] for it in items], np.int32))


# -------------------------------------------------- RANSAC findHomography

def _read_homography():
    r = Reader(os.path.join(GOLDEN_DIR, "c_homography.bin"))
    recs = []
    while not r.eof():
        n = r.take("i")
        noise = r.take("d")
        outfrac = r.take("d")
        src = np.frombuffer(r.take_bytes(16 * n), "<f8").reshape(n, 2).copy()
        dst = np.frombuffer(r.take_bytes(16 * n), "<f8").reshape(n, 2).copy()
        ret = r.take("i")
        H = np.frombuffer(r.take_bytes(72), "<f8").reshape(3, 3).copy()
        mask = np.frombuffer(r.take_bytes(n), "u1").astype(bool).copy()
        inliers = r.take("i")
        recs.append((n, noise, outfrac, src, dst, ret, H, mask, inliers))
    return recs


def test_ransac_homography_vs_bundled_c():
    """siriltpu's RANSAC (registration/ransac.py) vs the reference's
    BUNDLED OpenCV-2 findHomography compiled verbatim into the harness
    (fundam.cpp:84 runKernel, modelest.cpp:114 runRANSAC,
    calibration.cpp:202 CvLevMarq) on 60 star-pair fixtures.

    Tolerance rationale: both pipelines RANSAC at the same 3-px
    threshold then refit on inliers; the C adds an LM geometric refine
    (ours is the algebraic DLT refit), and inlier sets may differ on
    boundary points — so agreement is asserted as TRANSFER error over
    the C's inlier points: exact cases agree to ~1e-6 px, noisy cases
    within 0.5 px (vs 0.3-px point noise and the 3-px clip radius)."""
    from siriltpu.registration.ransac import find_homography

    recs = _read_homography()
    assert len(recs) == 60
    for n, noise, outfrac, src, dst, ret, Hc, mask, inliers in recs:
        assert ret == 1, "C failed a fixture it should solve"
        # golden self-check: the C's H maps its inliers within threshold
        ph = np.column_stack([src[mask], np.ones(mask.sum())]) @ Hc.T
        proj_c = ph[:, :2] / ph[:, 2:3]
        derr = np.hypot(*(proj_c - dst[mask]).T)
        assert derr.max() <= 3.0 + 1e-6

        res = find_homography(src, dst)
        assert res is not None, (n, noise, outfrac)
        Ho, inl = res
        # our inlier count within 10% of the C's
        assert inl.sum() >= 0.9 * inliers, (n, noise, outfrac,
                                            int(inl.sum()), inliers)
        # transfer agreement over the C's inlier points
        po = np.column_stack([src[mask], np.ones(mask.sum())]) @ Ho.T
        proj_o = po[:, :2] / po[:, 2:3]
        terr = np.hypot(*(proj_o - proj_c).T).max()
        tol = 1e-4 if noise == 0.0 else 0.5
        assert terr <= tol, (n, noise, outfrac, terr)


# ------------------------------------------------------------- ECC aligner

def test_ecc_translation_vs_bundled_c():
    """siriltpu's ECC (ops/ecc.py) vs the reference's bundled aligner
    (src/opencv/ecc/ecc.cpp compiled VERBATIM against the mini cv::Mat
    shim) on 10 planet-style fixtures with known sub-pixel shifts.

    Both run the same Evangelidis-Psarakis iteration (5x5 fixed
    Gaussian, [-.5 0 .5] gradients, masked zero-means, illumination
    lambda, Gauss-Newton, 50 it / 1e-3 stop) after the reference's
    SATURATING 16->8-bit convert; tolerance 0.05 px covers the f32
    iteration-order and warp-interpolation differences (the harness
    warp uses float weights, OpenCV quantizes coords to 1/32 px)."""
    from siriltpu.ops.ecc import ecc_find_translation

    r = Reader(os.path.join(GOLDEN_DIR, "c_ecc.bin"))
    ncase = 0
    while not r.eof():
        h = r.take("i")
        w = r.take("i")
        true_dx = r.take("d")
        true_dy = r.take("d")
        ref = r.take_u16s(h * w).reshape(h, w)
        img = r.take_u16s(h * w).reshape(h, w)
        ret = r.take("i")
        cdx, cdy = r.take("f"), r.take("f")
        ncase += 1
        assert ret == 0, "C ECC failed a fixture"
        # golden self-check: the C recovered the planted shift
        assert abs(cdx - (-true_dx)) < 0.05, (ncase, cdx, true_dx)
        assert abs(cdy - (-true_dy)) < 0.05, (ncase, cdy, true_dy)
        dx, dy, rho = ecc_find_translation(ref, img)
        assert rho > 0.9
        assert abs(dx - cdx) < 0.05, (ncase, dx, cdx)
        assert abs(dy - cdy) < 0.05, (ncase, dy, cdy)
    assert ncase == 10


# ------------------------------------------------------------------ dftreg

def test_dftreg_peak_decode_matches_compiled_reference():
    """register_shift_dft's correlation-peak scan + wraparound decode
    (registration.c:337-354) compiled verbatim, driven with precomputed
    surfaces (random, planted wraparound peaks, ties, all-negative,
    constant, index-0 peak) — our decode must match every case, and the
    jitted batch path must agree with the host decode."""
    import jax.numpy as jnp

    from siriltpu.ops.fftreg import decode_corr_peak

    r = Reader(os.path.join(GOLDEN_DIR, "c_dftreg.bin"))
    ncases = 0
    for _ in range(3 * 12):
        size = r.take("H")
        corr = np.frombuffer(r.buf, "<f8", size * size, r.off).reshape(
            size, size)
        r.off += 8 * size * size
        c_sx = r.take("i")
        c_sy = r.take("i")
        sx, sy = decode_corr_peak(corr)
        assert (sx, sy) == (c_sx, c_sy), (size, ncases)
        # the device argmax/decode in phase_correlate is the same math:
        # replicate it on the surface directly
        flat = jnp.asarray(corr, jnp.float64).reshape(1, -1)
        idx = int(jnp.argmax(flat, axis=1)[0])
        dy, dx = divmod(idx, size)
        dy = dy - size if dy > size // 2 else dy
        dx = dx - size if dx > size // 2 else dx
        assert (dx, dy) == (c_sx, c_sy)
        ncases += 1
    # ---- part 2: q tracking + normalizeQualityData ----
    from siriltpu.ops.quality import normalize_quality
    for _ in range(3):
        nf = r.take("H")
        process_all = bool(r.take("H"))
        incl = np.zeros(nf, bool)
        q_in = np.zeros(nf)
        for i in range(nf):
            incl[i] = bool(r.take("H"))
            q_in[i] = r.take("d")
        c_qmin = r.take("d")
        c_qmax = r.take("d")
        c_qidx = r.take("i")
        c_qnorm = np.array([r.take("d") for _ in range(nf)])
        sel = np.ones(nf, bool) if process_all else incl
        idxs = np.nonzero(sel)[0]
        assert np.isclose(c_qmin, q_in[idxs].min())
        assert np.isclose(c_qmax, q_in[idxs].max())
        # first strict max wins (duplicate-max scenario included)
        assert c_qidx == idxs[int(np.argmax(q_in[idxs]))]
        ours = q_in.copy()
        ours[idxs] = normalize_quality(q_in[idxs])
        np.testing.assert_allclose(ours, c_qnorm, rtol=0, atol=1e-15)
    assert r.eof()


def test_rejection_pallas_vs_c():
    """The fused GPU kernel (Pallas, Triton route, in interpret mode)
    reproduces the compiled C's mean AND counters on every golden vector
    it takes: sigma at F in [5, F_MAX], through the degenerate-exact
    hybrid. The other rejections run the plain path, which the tests
    above anchor to the same goldens."""
    import jax.numpy as jnp

    from siriltpu.ops.pallas.reject_stack import fused_applies, fused_stack

    groups = {}
    for t, kind, n, sig0, sig1, vec, mean, rej0, rej1 in _read_rejection():
        if (REJ_NAMES[t] in ("sigma", "sigma_masked")
                and fused_applies("sigma", n)):
            groups.setdefault((n, sig0, sig1), []).append(
                (vec, mean, rej0, rej1))
    assert groups
    bad = []
    for (n, sig0, sig1), items in groups.items():
        vals = np.stack([it[0] for it in items], axis=1).astype(np.uint16)
        mean, rl, rh = (np.asarray(a) for a in fused_stack(
            jnp.asarray(vals), "sigma", sig0, sig1, interpret=True))
        for i, (vec, wmean, w0, w1) in enumerate(items):
            if (int(mean[i]) != int(wmean) or int(rl[i]) != int(w0)
                    or int(rh[i]) != int(w1)):
                bad.append((n, sig0, sig1, i,
                            (int(mean[i]), int(rl[i]), int(rh[i])),
                            (int(wmean), int(w0), int(w1))))
    assert not bad, f"{len(bad)} fused-kernel mismatches vs C: {bad[:5]}"
