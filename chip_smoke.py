"""Smoke run of the main path on one NVIDIA GPU, at the north-star size.

    python chip_smoke.py [--seed N]          # phases a-d + the gpu tests
    python chip_smoke.py --four-cards        # only the multi-device paths

Phases (each raises on failure; the run exits 0 only if all pass):

a. CLI session: 100 synthetic 4096x4096 mono FITS lights, then the
   command layer's ``cd / seqload / boxselect / register dft /
   stack mean sigma 3 3``. Recovered shifts must equal the generated
   ones; a 64-row full-width band of the stacked FITS must be within
   1 LSB of ``verify/oracle.stack_mean_rejection``.
b. Library north star: ``register_and_stack`` on 100 x 4096^2
   device-resident frames, seconds per batch, bit-equal to the plain
   XLA stack (the rejection statistics are integer-exact: 0 LSB).
c. The fused rejection kernel against the plain path at F=100 and F=25,
   P=4096^2, sigma and median, counters included, with both timings
   and the compiled kernel's memory analysis.
d. Star finding and warping on a 3072x2048 starfield, against the same
   calls pinned to the CPU device (tolerances and their reason in
   ``phase_starfind_warp``).
e. The tests marked ``gpu`` (compiled kernels against the plain path).

``--four-cards`` runs only the multi-device paths the library exposes,
each against its one-card result, bit for bit: the row-slab sigma stack,
the frames-mesh register+stack step, and the frames-mesh global star
alignment, on a flat mesh over four cards.

One process drives the card(s); the oracle of phase a runs in worker
processes that never touch JAX. Without a GPU the run prints no result
and exits non-zero. The last line is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(ROOT, "siril-0.9")

NFRAMES, SIZE, SEL = 100, 4096, 512


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def timed(fn, reps: int):
    """(last result, seconds per call) over ``reps`` calls after one
    warm-up call, each synced with ``block_until_ready``."""
    import jax
    out = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    return out, (time.perf_counter() - t0) / reps


def bench_frames(seed: int, nframes: int, size: int):
    """(device frames (F, H, W) uint16, generated shifts (F, 2)): one
    starfield from ``seed`` with known integer shifts plus noise."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from siriltpu.pipelines.register_stack import _make_bench_frames

    rng = np.random.default_rng(seed)
    shifts = rng.integers(-20, 21, size=(nframes, 2)).astype(np.int32)
    shifts[0] = 0
    frames = _make_bench_frames(jax.random.PRNGKey(seed),
                                jnp.asarray(shifts), nframes, size)
    return jax.block_until_ready(frames), shifts


def center_sel(size: int):
    s = min(SEL, size // 2)
    return ((size - s) // 2, (size - s) // 2, s)


def card_allocs(devs):
    """Buffers each device has allocated so far."""
    return [d.memory_stats()["num_allocs"] for d in devs]


def _oracle_rows(args):
    """Oracle rows for one slice of the band (runs in a worker)."""
    band, shifts_x = args
    import numpy as np
    from siriltpu.verify.oracle import stack_mean_rejection
    shifts = np.stack([shifts_x, np.zeros_like(shifts_x)], axis=1)
    return stack_mean_rejection(band[:, None], shifts, "sigma",
                                (3.0, 3.0))[0]


def oracle_band(frames, shifts, y0: int, rows: int):
    """``stack_mean_rejection`` for output rows [y0, y0 + rows) of a
    shifted stack. The band lies inside every frame's y-shifted window,
    so each frame's source rows are cut out first (an exact integer y
    shift) and the oracle applies only the x shifts; worker processes
    share the rows."""
    import multiprocessing as mp

    import numpy as np
    band = np.stack([frames[i, y0 - sy: y0 - sy + rows]
                     for i, sy in enumerate(shifts[:, 1])])
    nproc = max(1, min(os.cpu_count() or 1, rows))
    chunks = [(band[:, r: r + 1], shifts[:, 0]) for r in range(rows)]
    with mp.get_context("spawn").Pool(nproc) as pool:
        return np.concatenate(pool.map(_oracle_rows, chunks), axis=0)


# ----------------------------------------------------------------- phases

def phase_cli(seed: int, band_rows: int = 64) -> str:
    """a. The command layer on FITS files, against the oracle."""
    import numpy as np
    from siriltpu.cli.main import main as cli_main
    from siriltpu.core.frame import Frame
    from siriltpu.io import fits as fits_io
    from siriltpu.io.seqfile import read_seqfile

    nframes, size = NFRAMES, SIZE
    frames_dev, gen = bench_frames(seed, nframes, size)
    frames = np.asarray(frames_dev)
    del frames_dev
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as work:
        t0 = time.perf_counter()
        for i in range(nframes):
            fits_io.write_fits(os.path.join(work, f"light{i + 1:03d}.fit"),
                               Frame(frames[i][None]))
        t_write = time.perf_counter() - t0
        x0, y0, s = center_sel(size)
        script = os.path.join(work, "session.ssf")
        with open(script, "w") as fh:
            fh.write(f"cd {work}\nseqload light\nboxselect {x0} {y0} {s} {s}"
                     "\nregister dft\nstack mean sigma 3 3\n")
        # the command layer's own entry point, in this process: a second
        # JAX process could not reserve the card
        t0 = time.perf_counter()
        rc = cli_main(["-s", script])
        t_cli = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"CLI session failed (rc={rc})")
        got = read_seqfile(os.path.join(work, "light.seq")).reg_shifts(0)
        if not np.array_equal(np.asarray(got, np.int64), -gen.astype(np.int64)):
            raise AssertionError("recovered shifts differ from the "
                                 "generated ones")
        stacked = fits_io.read_fits(
            os.path.join(work, "light_stacked.fit")).data[0]
    yb = size // 2 - band_rows // 2
    t0 = time.perf_counter()
    want = oracle_band(frames, -gen, yb, band_rows)
    t_oracle = time.perf_counter() - t0
    diff = np.abs(stacked[yb: yb + band_rows].astype(np.int64)
                  - want.astype(np.int64))
    if stacked.shape != (size, size) or diff.max() > 1:
        raise AssertionError(f"stack vs oracle: max |diff| {diff.max()}")
    return (f"{nframes} FITS {size}x{size} written in {t_write:.1f} s; "
            f"CLI register+stack {t_cli:.1f} s; shifts exact; "
            f"{band_rows}x{size} band vs oracle max |diff| {diff.max()} LSB "
            f"({(diff > 0).mean():.2e} of pixels off by 1; oracle "
            f"{t_oracle:.1f} s)")


def phase_north_star(seed: int) -> str:
    """b. register_and_stack, fused vs plain XLA, bit for bit."""
    import jax.numpy as jnp
    import numpy as np
    from siriltpu.pipelines.register_stack import register_and_stack

    frames, gen = bench_frames(seed, NFRAMES, SIZE)

    def run(fused, block_rows=256):
        return lambda: register_and_stack(
            frames, sel=center_sel(SIZE), block_rows=block_rows,
            return_device=True, keep_frames=True, fused=fused)

    (out_f, (sx, sy), _), t_f = timed(run(True), reps=5)
    if not (np.array_equal(np.asarray(sx), -gen[:, 0])
            and np.array_equal(np.asarray(sy), -gen[:, 1])):
        raise AssertionError("register_and_stack: wrong shifts")
    (out_p, _, _), t_p = timed(run(False), reps=2)
    if not bool(jnp.array_equal(out_f, out_p)):
        n = int(jnp.sum(out_f != out_p))
        raise AssertionError(f"fused stack != plain stack at {n} pixels")
    return (f"register_and_stack {NFRAMES}x{SIZE}^2: {t_f:.4f} s/batch "
            f"({NFRAMES / t_f:.1f} frames/s) with the fused kernel, "
            f"{t_p:.4f} s/batch plain XLA; outputs bit-equal")


def phase_kernel(seed: int) -> str:
    """c. The fused kernel against the plain path, F=100 and F=25."""
    import jax
    import jax.numpy as jnp
    from siriltpu.ops.pallas.reject_stack import fused_stack
    from siriltpu.ops.rejection import masked_median, reject_and_mean
    from siriltpu.pipelines.register_stack import (align_frames_auto_keep,
                                                   compute_shifts)

    frames, _ = bench_frames(seed, NFRAMES, SIZE)
    sx, sy = compute_shifts(frames, 0, center_sel(SIZE))
    vals = align_frames_auto_keep(frames, sx, sy).reshape(NFRAMES, -1)
    del frames
    chunk = 1 << 21  # the plain path runs over pixel chunks

    def plain(fn):
        f = jax.jit(fn)
        return lambda v: [jnp.concatenate(parts) for parts in zip(*(
            f(v[:, i: i + chunk]) for i in range(0, v.shape[1], chunk)))]

    plain_sigma = plain(lambda v: reject_and_mean(v, "sigma", (3.0, 3.0),
                                                  fused=False))
    plain_median = plain(lambda v: (masked_median(v, fused=False),))
    kernels = {"sigma": jax.jit(lambda x: fused_stack(x, "sigma", 3.0, 3.0)),
               "median": jax.jit(lambda x: fused_stack(x, "median")[:1])}
    lines = []
    for f in (100, 25):
        v = vals[:f]
        for rej in ("sigma", "median"):
            compiled = kernels[rej].lower(v).compile()
            got, t_k = timed(lambda: compiled(v), reps=5)
            pl = plain_sigma if rej == "sigma" else plain_median
            want, t_p = timed(lambda: pl(v), reps=2)
            for g, w, name in zip(got, want, ("mean", "rejlow", "rejhigh")):
                if not bool(jnp.array_equal(g, w)):
                    raise AssertionError(f"{rej} F={f}: kernel {name} != "
                                         "plain")
            lines.append(f"{rej} F={f} P={SIZE}^2: kernel {t_k:.4f} s, "
                         f"plain {t_p:.4f} s, equal incl. counters; "
                         f"memory {compiled.memory_analysis()}")
    return "\n  ".join(lines)


def phase_starfind_warp(seed: int) -> str:
    """d. peaker + warp_perspective on the card vs pinned to the CPU.

    Tolerances: star positions within 1e-3 px; warped pixels within
    1 LSB, or, on steep star edges, within 1 LSB plus 1e-3 px times the
    local gradient. Both sides run the same float32 formulas, but the
    GPU backend contracts multiply-adds into FMAs and sums in other
    orders, so a source coordinate near x = 3000 can differ by a few ulp
    (ulp = 2.4e-4 px); an interpolated pixel then moves by that offset
    times the image gradient, which reaches thousands of LSB per pixel
    at a star's edge."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.ndimage import maximum_filter
    from siriltpu.ops.starfind import peaker
    from siriltpu.ops.warp import INTER_CUBIC, warp_perspective
    from siriltpu.testing.synth import starfield

    h, w = 2048, 3072
    img, _ = starfield(h, w, nstars=300, seed=seed)
    layer = img[0]
    hinv = np.linalg.inv(np.array(
        [[1.0, 0.001, 2.3], [-0.001, 1.0, -1.7], [0.0, 0.0, 1.0]]))
    warp = jax.jit(lambda im, hm: warp_perspective(im, hm, (h, w),
                                                   INTER_CUBIC))

    def run():
        stars = peaker(layer)
        warped = np.asarray(warp(jnp.asarray(layer, jnp.float32),
                                 jnp.asarray(hinv, jnp.float32)))
        return stars, warped.astype(np.float64)

    s_gpu, w_gpu = run()
    with jax.default_device(jax.devices("cpu")[0]):
        s_cpu, w_cpu = run()
    if not s_gpu or len(s_gpu) != len(s_cpu):
        raise AssertionError(f"star count {len(s_gpu)} on the card vs "
                             f"{len(s_cpu)} on the CPU")
    dpos = max(max(abs(a.xpos - b.xpos), abs(a.ypos - b.ypos))
               for a, b in zip(s_gpu, s_cpu))
    grad = np.maximum(np.abs(np.diff(w_cpu, axis=0, append=w_cpu[-1:])),
                      np.abs(np.diff(w_cpu, axis=1, append=w_cpu[:, -1:])))
    bound = 1.0 + 1e-3 * maximum_filter(grad, size=5)
    dpix = np.abs(w_gpu - w_cpu)
    if dpos > 1e-3 or (dpix > bound).any():
        raise AssertionError(f"positions differ by {dpos} px; "
                             f"{int((dpix > bound).sum())} warped pixels "
                             f"beyond the bound (max diff {dpix.max()})")
    return (f"{len(s_gpu)} stars on both; max position diff {dpos:.2e} px; "
            f"warped pixels: max diff {dpix.max():.3g}, "
            f"{int((dpix > 1).sum())} of {dpix.size} beyond 1 LSB, all "
            "within the gradient bound")


def phase_gpu_tests() -> str:
    """e. The tests marked gpu, in this process."""
    import pytest

    class Count:
        def __init__(self):
            self.passed, self.other = 0, []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.outcome != "passed":
                self.other.append((report.nodeid, report.outcome))

    count = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_pallas_kernels.py")],
                     plugins=[count])
    if rc != 0 or count.other or not count.passed:
        raise AssertionError(f"gpu tests: rc={rc}, not passed: {count.other}")
    return f"{count.passed} gpu-marked tests passed"


def phase_four_cards(seed: int) -> str:
    """The multi-device paths on a flat mesh, each against one card."""
    import jax
    import numpy as np
    from siriltpu.ops.rejection import reject_and_mean
    from siriltpu.parallel.mesh import make_mesh
    from siriltpu.parallel.sharded import (make_rows_sigma_stack,
                                           make_sharded_register_stack,
                                           register_stack_step)
    from siriltpu.pipelines.register_stack import (align_frames_auto_keep,
                                                   compute_shifts)
    from siriltpu.registration.global_star import global_align_batch
    from siriltpu.testing.synth import starfield

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, JAX sees "
                           f"{len(devs)}")
    mesh = make_mesh(devices=devs)
    one = devs[0]
    lines = []

    def spread_check(name, before):
        """Every card allocated buffers for this path: none of them left
        the work to jax.devices()[0]."""
        grown = [a - b for a, b in zip(card_allocs(devs), before)]
        if min(grown) <= 0:
            raise AssertionError(f"{name}: a card did no work "
                                 f"(allocations per card {grown})")
        return grown

    frames_dev, gen = bench_frames(seed, NFRAMES, SIZE)
    sx, sy = compute_shifts(frames_dev, 0, center_sel(SIZE))
    aligned = np.asarray(align_frames_auto_keep(frames_dev, sx, sy))
    frames = np.asarray(frames_dev)
    del frames_dev

    # row-slab sigma stack: every card stacks a quarter of the rows
    before = card_allocs(devs)
    slab = make_rows_sigma_stack(mesh)
    t0 = time.perf_counter()
    out4 = slab(aligned)
    t4 = time.perf_counter() - t0
    grown = spread_check("row-slab stack", before)
    v1 = jax.device_put(aligned.reshape(NFRAMES, -1), one)
    out1 = np.asarray(jax.jit(lambda v: reject_and_mean(
        v, "sigma", (3.0, 3.0))[0])(v1)).reshape(SIZE, SIZE)
    del v1
    if not np.array_equal(out4, out1):
        raise AssertionError("row-slab stack on 4 cards != one card")
    lines.append(f"row-slab sigma stack {NFRAMES}x{SIZE}^2 on 4 cards == 1 "
                 f"card ({t4:.2f} s incl. upload and compile; allocations "
                 f"per card {grown})")

    # frames-mesh register + stack step (GSPMD re-shards for the stack)
    before = card_allocs(devs)
    run4 = make_sharded_register_stack(mesh, center_sel(SIZE))
    o4, sh4 = run4(frames)
    grown = spread_check("frames-mesh register+stack", before)
    step = jax.jit(register_stack_step(center_sel(SIZE)))
    o1, sx1, sy1 = step(jax.device_put(frames, one))
    if not (np.array_equal(o4, np.asarray(o1))
            and np.array_equal(sh4[:, 0], np.asarray(sx1))
            and np.array_equal(sh4[:, 1], np.asarray(sy1))):
        raise AssertionError("frames-mesh register_stack_step on 4 cards "
                             "!= one card")
    if not np.array_equal(sh4[:, 0], -gen[:, 0]):
        raise AssertionError("frames-mesh register_stack_step: wrong shifts")
    lines.append(f"frames-mesh register_stack_step {NFRAMES}x{SIZE}^2 on 4 "
                 f"cards == 1 card (allocations per card {grown})")

    # frames-mesh global star alignment
    rng = np.random.default_rng(seed)
    h, w, nstars = 2048, 3072, 150
    base = np.column_stack([
        rng.uniform(40, w - 40, nstars), rng.uniform(40, h - 40, nstars),
        rng.uniform(9000, 30000, nstars), rng.uniform(3.5, 6.0, nstars)])
    layers = []
    for _ in range(8):
        st = base.copy()
        st[:, :2] += rng.uniform(-6, 6, 2)
        layers.append(starfield(h, w, nstars, seed=seed, background=850,
                                noise_sigma=6.0, stars=st)[0][0])
    layers = np.stack(layers)
    before = card_allocs(devs)
    a4, r4 = global_align_batch(layers, 0, nmax=512, mesh=mesh)
    grown = spread_check("frames-mesh global alignment", before)
    with jax.default_device(one):
        a1, r1 = global_align_batch(layers, 0, nmax=512)
    if r4.failed or r4.registered != len(layers):
        raise AssertionError(f"global_align_batch on 4 cards: {r4}")
    if not np.array_equal(np.asarray(a4), np.asarray(a1)):
        raise AssertionError("global_align_batch on 4 cards != one card")
    lines.append(f"global_align_batch {len(layers)}x{w}x{h} on 4 cards == "
                 f"1 card (allocations per card {grown})")
    return "\n  ".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(PKG, "siriltpu")):
        print(f"chip_smoke.py: no siriltpu package under {PKG}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, PKG)
    from siriltpu.utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
              f"{dev.platform}", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    if args.four_cards:
        phases = [("four-cards", lambda: phase_four_cards(args.seed))]
    else:
        phases = [("a cli", lambda: phase_cli(args.seed)),
                  ("b north-star", lambda: phase_north_star(args.seed)),
                  ("c kernel", lambda: phase_kernel(args.seed)),
                  ("d starfind+warp", lambda: phase_starfind_warp(args.seed)),
                  ("e gpu tests", phase_gpu_tests)]
    for name, fn in phases:
        t0 = time.perf_counter()
        detail = fn()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            f"[{card}]\n  {detail}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
