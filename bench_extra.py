"""Extended benchmarks: the BASELINE.md eval configs 2-5 hot paths.

Prints one JSON line per workload. Sizes are tunable via env
(BENCHX_SCALE=0.25 quarters the pixel dimensions for a quick pass).
The north-star config 1 pipeline benchmark lives in bench.py. Device
stages are synced with ``block_until_ready``; stages that include host
I/O say so in their metric name.
"""

import json
import os
import sys
import time

_PKG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "siril-0.9")
if _PKG not in sys.path:
    sys.path.insert(0, _PKG)

SCALE = float(os.environ.get("BENCHX_SCALE", "1.0"))


def dim(x):
    return max(128, int(x * SCALE) & ~63)


def report(metric, seconds, unit="s", **extra):
    value = round(seconds, 4 if unit != "s" else 3)
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **extra}))


def best_of(fn, n=3):
    """Min wall time of n calls of ``fn``, each synced with
    ``block_until_ready``."""
    import jax
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    from siriltpu.utils.compcache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)

    # config 2: sigma-clip + median stacks, 50 x 2048^2
    from siriltpu.ops.rejection import masked_median, reject_and_mean
    F, H, W = 50, dim(2048), dim(2048)
    frames = jnp.clip(1500 + 80 * jax.random.normal(
        jax.random.PRNGKey(0), (F, H, W)), 0, 65535).astype(jnp.uint16)
    v = frames.reshape(F, H * W)
    sig = jax.jit(lambda x: reject_and_mean(x, "sigma", (3.0, 3.0))[0])
    jax.block_until_ready(sig(v))
    report(f"sigma-clip stack {F}x{H}x{W}", best_of(lambda: sig(v)))
    med = jax.jit(masked_median)
    vf = v.astype(jnp.float32)
    jax.block_until_ready(med(vf))
    report(f"median stack {F}x{H}x{W}", best_of(lambda: med(vf)))

    # config 3: register + winsorized, 1000 x 480x640
    from siriltpu.pipelines.register_stack import register_and_stack
    F3, H3, W3 = int(1000 * max(SCALE, 0.1)), dim(480), dim(640)
    shifts = rng.integers(-8, 9, (F3, 2)).astype(np.int32); shifts[0] = 0
    base = 1200.0 + 60.0 * jax.random.normal(jax.random.PRNGKey(1), (H3, W3))
    base = base.at[H3 // 3 : H3 // 3 + 40, W3 // 2 : W3 // 2 + 60].add(25000.0)
    def one(i):
        sh = jnp.asarray(shifts)[i]
        n = 10.0 * jax.random.normal(jax.random.fold_in(
            jax.random.PRNGKey(2), i), (H3, W3))
        return jnp.clip(jnp.roll(base, (sh[1], sh[0]), (0, 1)) + n,
                        0, 65535).astype(jnp.uint16)
    fr3 = jax.block_until_ready(jax.lax.map(one, jnp.arange(F3)))
    s = min(256, H3 // 2, W3 // 2)
    sel = ((W3 - s) // 2, (H3 - s) // 2, s)
    o, sh, q = register_and_stack(jnp.array(fr3), sel=sel,
                                  rejection="winsorized", block_rows=96,
                                  with_quality=True, return_device=True)
    jax.block_until_ready(o)
    t0 = time.perf_counter()
    o, sh, q = register_and_stack(jnp.array(fr3), sel=sel,
                                  rejection="winsorized", block_rows=96,
                                  with_quality=True, return_device=True)
    jax.block_until_ready(o)
    dt = time.perf_counter() - t0
    report(f"register+winsorized {F3}x{H3}x{W3} (frames/s)", F3 / dt,
           unit="frames/s")

    # config 4 hot ops: starfind + cubic warp at DSLR scale
    from siriltpu.ops.starfind import peaker
    from siriltpu.ops.warp import warp_perspective, INTER_CUBIC
    from siriltpu.testing.synth import starfield
    H4, W4 = dim(2048), dim(3072)
    img, _st = starfield(H4, W4, nstars=300, seed=2)
    peaker(img[0])
    t0 = time.perf_counter(); found = peaker(img[0])
    report(f"starfind {W4}x{H4} ({len(found)} stars)",
           time.perf_counter() - t0)
    Hinv_np = np.linalg.inv(np.array(
        [[1.0, 0.001, 2.3], [-0.001, 1.0, -1.7], [0, 0, 1.0]]))
    Hm = jnp.asarray(Hinv_np, jnp.float32)
    d = jnp.asarray(img[0].astype(np.float32))
    # the production registration path is the TILED banded sampler
    # (warp.py); the gather fallback only runs for far-from-identity
    # warps — measure both, with the tiled one as the headline stage
    from siriltpu.ops.warp import _tiled_plan, _warp_perspective_tiled
    plan = _tiled_plan(Hinv_np, (H4, W4), (H4, W4), INTER_CUBIC)
    assert plan is not None
    jax.block_until_ready(_warp_perspective_tiled(d, Hm, (H4, W4),
                                                  INTER_CUBIC, *plan))
    report(f"warp cubic {W4}x{H4} (tiled, production path)", best_of(
        lambda: _warp_perspective_tiled(d, Hm, (H4, W4), INTER_CUBIC,
                                        *plan)))
    wfn = jax.jit(lambda im, h: warp_perspective(im, h, (H4, W4),
                                                 INTER_CUBIC))
    jax.block_until_ready(wfn(d, Hm))
    report(f"warp cubic {W4}x{H4} (gather fallback)", best_of(
        lambda: wfn(d, Hm)))

    # config 4: VNG + AHD demosaic at DSLR scale: the device figure
    # (input resident) and the buffer-level call incl. the host round
    # trip.
    from siriltpu.ops.demosaic import (_VNG_FILTERS, _ahd_jax_fn,
                                       _vng_jax_fn, debayer_buffer)
    H5, W5 = dim(3672), dim(5496)
    cfa = rng.integers(0, 16000, (H5, W5)).astype(np.uint16)
    cfad = jax.block_until_ready(jnp.asarray(cfa))
    filters = _VNG_FILTERS["RGGB"]
    for m, fn in (("vng", _vng_jax_fn(H5, W5, filters)),
                  ("ahd", _ahd_jax_fn(H5, W5, filters))):
        jax.block_until_ready(fn(cfad))
        report(f"{m} demosaic {W5}x{H5} (device)", best_of(
            lambda: fn(cfad)))
        t0 = time.perf_counter(); debayer_buffer(cfa, "RGGB", m)
        report(f"{m} demosaic {W5}x{H5} (incl. host round-trip)",
               time.perf_counter() - t0)

    # config 5: bgextract + autostretch at 6K x 4K RGB
    from siriltpu.ops.background import subtract_background
    from siriltpu.ops.histogram_ops import autostretch
    H6, W6 = dim(4096), dim(6144)
    yy, xx = np.mgrid[0:H6, 0:W6]
    rgb = np.clip(rng.normal(800 + 0.08 * yy + 0.05 * xx, 40, (3, H6, W6)),
                  0, 65535).astype(np.uint16)
    t0 = time.perf_counter(); sub = subtract_background(rgb)
    report(f"bgextract order4 {W6}x{H6} RGB", time.perf_counter() - t0)
    t0 = time.perf_counter(); autostretch(sub)
    report(f"autostretch {W6}x{H6} RGB", time.perf_counter() - t0)

    # batched ECC registration throughput (the reference's OpenMP-over-
    # frames loop, registration.c:849-852 / ecc.cpp:307) — frames/s for
    # 100x 640x480 via the vmapped device kernel
    from siriltpu.ops.ecc import ecc_translation_batch
    He, We = 480, 640
    Fe = int(100 * max(SCALE, 0.1))
    base_e = jnp.clip(1200 + 60 * jax.random.normal(
        jax.random.PRNGKey(7), (He, We)), 0, 65535)
    base_e = base_e.at[He // 3: He // 3 + 30, We // 2: We // 2 + 50].add(20000.0)
    she = rng.integers(-6, 7, (Fe, 2)).astype(np.int32)
    def one_e(i):
        sh = jnp.asarray(she)[i]
        return jnp.roll(base_e, (sh[1], sh[0]), (0, 1))
    fre = jax.lax.map(one_e, jnp.arange(Fe))
    # 8-bit saturation like register_ecc (registration.c:820-848)
    tmpl8 = jnp.minimum(base_e / 257.0, 255.0)
    fre8 = jnp.minimum(fre / 257.0, 255.0)
    ecc_fn = jax.jit(ecc_translation_batch)
    jax.block_until_ready(ecc_fn(tmpl8, fre8))
    dt = best_of(lambda: ecc_fn(tmpl8, fre8))
    report(f"ECC registration batched {Fe}x{We}x{He} (frames/s)", Fe / dt,
           unit="frames/s")

    # FILE-BACKED register+stack: a real SER on disk -> streaming
    # double-buffered block reads -> device stack; fps INCLUDES all I/O.
    import tempfile
    from siriltpu.core.frame import Frame
    from siriltpu.io.ser import SerFile
    from siriltpu.io.sequence import ser_sequence
    from siriltpu.core.frame import Rect
    from siriltpu.registration.translation import register_shift_dft
    from siriltpu.stacking.api import stack_sequence
    Ff, Hf, Wf = int(200 * max(SCALE, 0.1)), dim(480), dim(640)
    tdir = tempfile.mkdtemp()
    path = os.path.join(tdir, "capture.ser")
    ser = SerFile.create(path, width=Wf, height=Hf, color_id=0)
    basef = np.clip(1200 + 60 * rng.standard_normal((Hf, Wf)), 0, 60000)
    basef[Hf // 3: Hf // 3 + 30, Wf // 2: Wf // 2 + 50] += 20000
    shf = rng.integers(-6, 7, (Ff, 2)).astype(np.int32); shf[0] = 0
    for i in range(Ff):
        fr = np.roll(basef, (shf[i, 1], shf[i, 0]), (0, 1))
        fr = fr + rng.normal(0, 10, (Hf, Wf))
        ser.write_frame(Frame(np.clip(fr, 0, 65535).astype(np.uint16)[None]))
    ser.write_and_close()
    t0 = time.perf_counter()
    seq = ser_sequence(path)
    sq = min(256, Hf // 2, Wf // 2)
    register_shift_dft(seq, 0, Rect((Wf - sq) // 2, (Hf - sq) // 2, sq, sq))
    res = stack_sequence(seq, method="mean", filter_type="all",
                         rejection="sigma", sig=(3.0, 3.0),
                         normalize="none", stream=True)
    assert res.data.shape[0] == 1
    dt = time.perf_counter() - t0
    report(f"FILE-BACKED SER register+stack {Ff}x{Wf}x{Hf} incl. I/O "
           f"(frames/s)", Ff / dt, unit="frames/s")

    # config 4 END-TO-END: global star alignment (peaker -> triangle
    # match -> RANSAC homography -> warp) over an in-memory sequence of
    # deep-sky frames, the richest registration path
    # (registration.c:525-784)
    from siriltpu.io.sequence import internal_sequence
    from siriltpu.registration.global_star import register_global_star
    from siriltpu.testing.synth import make_sequence_frames
    Fg, Hg, Wg = int(20 * max(SCALE, 0.1)), dim(2048), dim(3072)
    gframes, gshifts, _ = make_sequence_frames(Fg, Hg, Wg, seed=1,
                                               nstars=120)
    gseq = internal_sequence([Frame(f) for f in gframes])
    out_frames = []
    t0 = time.perf_counter()
    rep = register_global_star(gseq, 0, write_output=False,
                               output_frames=out_frames)
    dt = time.perf_counter() - t0
    assert rep.registered >= Fg - 1, rep
    report(f"global star alignment {Fg}x{Wg}x{Hg} (frames/s)", Fg / dt,
           unit="frames/s")

    # config 4 FILE-BACKED: the chunked register path end-to-end from a
    # SER on disk (loader thread -> batched star find -> host match ->
    # batched warp -> SER write-back). Every frame crosses the host link
    # twice (upload for star-find+warp, download of the warped frame);
    # the achieved payload MB/s is reported beside the raw link rate of
    # a bare device_put of the same buffer.
    from siriltpu.io.sequence import ser_sequence as _ser_seq
    Fc4, Hc4, Wc4 = int(12 * max(SCALE, 0.1)), dim(2048), dim(3072)
    c4dir = tempfile.mkdtemp()
    c4path = os.path.join(c4dir, "dslr.ser")
    ser4 = SerFile.create(c4path, width=Wc4, height=Hc4)
    c4base = np.column_stack([
        rng.uniform(40, Wc4 - 40, 150), rng.uniform(40, Hc4 - 40, 150),
        rng.uniform(9000, 30000, 150), rng.uniform(3.5, 6.0, 150)])
    from siriltpu.testing.synth import starfield as _sf
    for i in range(Fc4):
        st = c4base.copy()
        st[:, 0] += rng.uniform(-6, 6)
        st[:, 1] += rng.uniform(-6, 6)
        m4, _ = _sf(Hc4, Wc4, 150, seed=21, background=850,
                    noise_sigma=6.0, stars=st)
        ser4.write_frame(Frame(m4))
    ser4.write_and_close()
    # raw link rate: one frame-sized buffer, device_put + sync
    buf = np.zeros((Hc4, Wc4), np.uint16)
    jax.block_until_ready(jax.device_put(buf))
    t0 = time.perf_counter()
    jax.block_until_ready(jax.device_put(buf))
    raw_mbps = buf.nbytes / (time.perf_counter() - t0) / 1e6
    seq4 = _ser_seq(c4path)
    from siriltpu.registration.global_star import register_global_star as _rgs
    t0 = time.perf_counter()
    rep4 = _rgs(seq4, 0)
    dt = time.perf_counter() - t0
    assert rep4.failed == 0, rep4
    payload = 2 * Fc4 * Hc4 * Wc4 * 2  # up + down, uint16
    ach_mbps = payload / dt / 1e6
    report(f"config4 FILE-BACKED global alignment {Fc4}x{Wc4}x{Hc4} "
           "SER->register->SER (frames/s)", Fc4 / dt, unit="frames/s",
           payload_mbps=round(ach_mbps, 1),
           raw_link_mbps=round(raw_mbps, 1),
           link_saturation=round(ach_mbps / raw_mbps, 3))

    # config 5 END-TO-END: the full chain as ONE pipeline call
    # (pipelines/full.py): SER convert -> per-frame bgextract ->
    # register -> rejection stack -> autostretch -> FITS, on a 6Kx4K
    # RGB SER on disk. Reported as whole-chain frames/s incl. ALL I/O.
    from siriltpu.io.ser import SER_RGB, SerFile
    from siriltpu.pipelines.full import config5_pipeline
    H5, W5 = dim(4096), dim(6144)
    F5 = max(4, int(8 * max(SCALE, 0.1)))
    t5dir = tempfile.mkdtemp()
    path5 = os.path.join(t5dir, "lights.ser")
    ser5 = SerFile.create(path5, width=W5, height=H5, color_id=SER_RGB)
    sbase = np.column_stack([
        rng.uniform(40, W5 - 40, 400), rng.uniform(40, H5 - 40, 400),
        rng.uniform(9000, 30000, 400), rng.uniform(3.5, 6.0, 400)])
    yy5, xx5 = np.mgrid[0:H5, 0:W5]
    grad5 = (0.04 * (xx5 * 65535.0 / W5) + 0.02 * (yy5 * 65535.0 / H5))
    from siriltpu.testing.synth import starfield
    for i in range(F5):
        st = sbase.copy()
        st[:, 0] += rng.uniform(-5, 5)
        st[:, 1] += rng.uniform(-5, 5)
        mono5, _ = starfield(H5, W5, 400, seed=11, background=800,
                             noise_sigma=6.0, stars=st)
        fr5 = np.clip(np.repeat(mono5.astype(np.float32), 3, axis=0)
                      + grad5[None], 0, 65535).astype(np.uint16)
        ser5.write_frame(Frame(fr5))
    ser5.write_and_close()
    t0 = time.perf_counter()
    rep5 = config5_pipeline(path5, layer=1, rejection="winsorized")
    dt = time.perf_counter() - t0
    assert rep5.failed == 0, rep5
    stages = {k: round(v, 2) for k, v in rep5.stage_seconds.items()}
    report(f"config5 FULL CHAIN {F5}x{W5}x{H5} RGB (frames/s incl. I/O)",
           F5 / dt, unit="frames/s", stages_s=stages)


if __name__ == "__main__":
    main()
