"""Memory probe, timing, wave persistence, lrgb, new CLI verbs."""

import os

import numpy as np
import pytest

from siriltpu.cli.commands import process_command
from siriltpu.cli.main import make_state
from siriltpu.core.frame import Frame
from siriltpu.core.memory import (get_available_memory_mb,
                                  get_used_memory_mb, stacking_block_rows)
from siriltpu.io import fits as fits_io
from siriltpu.testing.synth import noise_frame
from siriltpu.utils.timing import format_time, timed


def test_memory_probe():
    assert get_available_memory_mb() > 0
    assert get_used_memory_mb() > 0
    rows = stacking_block_rows(4096, 100, memory_percent=0.1)
    assert rows >= 1


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self.device_kind, self._stats = platform, "fake", stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,want", [
    ("cpu", None, 2 << 30),
    ("gpu", {"bytes_limit": 60 << 30}, 60 << 30),
    ("gpu", {}, None),
    ("gpu", None, None),
])
def test_device_memory_budget(monkeypatch, platform, stats, want):
    """An accelerator's budget is the allocator's bytes_limit; only the
    CPU backend falls back to 2 GB, and an accelerator that reports no
    limit raises instead of guessing."""
    import jax

    from siriltpu.core.memory import get_device_memory_bytes
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice(platform, stats)])
    if want is None:
        with pytest.raises(RuntimeError):
            get_device_memory_bytes()
    else:
        assert get_device_memory_bytes() == want


def test_compile_cache_placement(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used exactly as given; without it the
    cache sits at the fixed in-checkout path, CPU artifacts one level
    down in a host-keyed directory."""
    import jax

    from siriltpu.utils import compcache
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setattr(compcache, "_ENABLED", "")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compcache.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)

        monkeypatch.setattr(compcache, "_ENABLED", "")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        got = compcache.enable_compilation_cache()
        assert os.path.dirname(got) == compcache.DEFAULT_DIR
        assert os.path.basename(got).startswith("cpu-")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert compcache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_timing_format():
    assert format_time(0.001).endswith("ms")
    assert format_time(5).endswith(" s")
    assert format_time(90).endswith("min")
    logs = []
    with timed("op", log=logs.append):
        pass
    assert "Execution time" in logs[0]


def test_wave_io_roundtrip(tmp_path):
    from siriltpu.ops.wave_io import wave_read, wave_write
    planes = np.random.default_rng(0).normal(size=(3, 8, 10)).astype(np.float32)
    p = str(tmp_path / "t.wave")
    wave_write(p, planes, 2)
    got, kind = wave_read(p)
    assert kind == 2
    np.testing.assert_array_equal(got, planes)


def test_wrecons_from_disk(tmp_path):
    """wrecons works in a fresh session by reloading the .wave swap files."""
    state = make_state(str(tmp_path))
    data = noise_frame(64, 64, seed=5, mean=2000, sigma=300)
    fits_io.write_fits(os.path.join(state.cwd, "img.fit"), Frame(data))
    process_command(state, "load img")
    assert process_command(state, "wavelet 3") == 0
    state._wavelets = None  # simulate a fresh session
    assert process_command(state, "wrecons 1 1 1") == 0
    err = np.abs(state.image.data.astype(int) - data.astype(int)).max()
    assert err <= 1


def test_lrgb_op():
    from siriltpu.ops.imops import lrgb
    r = np.full((8, 8), 40000, np.uint16)
    g = np.full((8, 8), 20000, np.uint16)
    b = np.full((8, 8), 20000, np.uint16)
    l = np.full((8, 8), 28000, np.uint16)
    l[0, 0] = 65535  # luminance is normalized by its max (reference maxi)
    out = lrgb(l, r, g, b)
    assert out.shape == (3, 8, 8)
    # hue preserved (red dominant); lightness follows the L layer
    assert out[0, 4, 4] > out[1, 4, 4]
    l_out = 0.5 * (out.max(axis=0).astype(float) + out.min(axis=0))
    assert abs(float(l_out[4, 4]) - 28000) < 600


def test_cli_rgbcomp_and_seqexport(tmp_path):
    state = make_state(str(tmp_path))
    for name, val in [("r", 30000), ("g", 20000), ("b", 10000)]:
        fits_io.write_fits(os.path.join(state.cwd, name + ".fit"),
                           Frame(np.full((1, 8, 8), val, np.uint16)))
    assert process_command(state, "rgbcomp r g b") == 0
    assert state.image.nlayers == 3
    assert abs(int(state.image.data[0, 0, 0]) - 30000) <= 1

    # seqexport over a small FITS sequence
    from siriltpu.io.sequence import check_seq
    frames = [noise_frame(8, 8, seed=i) for i in range(3)]
    for i, f in enumerate(frames):
        fits_io.write_fits(os.path.join(state.cwd, f"q{i+1:02d}.fit"),
                           Frame(f))
    check_seq(state.cwd)
    assert process_command(state, "seqload q") == 0
    assert process_command(state, "seqexport out ser") == 0
    assert os.path.exists(os.path.join(state.cwd, "out.ser"))


def test_cli_lightcurve(tmp_path):
    from siriltpu.testing.synth import gaussian_star
    state = make_state(str(tmp_path))
    h = w = 64
    for i in range(3):
        img = 500.0 + gaussian_star(h, w, 32.0, 32.0, 20000.0, 6.0, 6.0)
        rng = np.random.default_rng(i)
        img = np.clip(np.rint(img + rng.normal(0, 4, img.shape)), 0,
                      65535).astype(np.uint16)
        fits_io.write_fits(os.path.join(state.cwd, f"lc{i+1:02d}.fit"),
                           Frame(img[None]))
    from siriltpu.io.sequence import check_seq
    check_seq(state.cwd)
    assert process_command(state, "seqload lc") == 0
    assert process_command(state, "boxselect 2 2 60 60") == 0
    # default photometry radii need a large box; shrink them
    assert process_command(state, "lightcurve") == 0
    assert os.path.exists(os.path.join(state.cwd, "light_curve.dat"))
    assert os.path.getsize(os.path.join(state.cwd, "light_curve.svg")) > 500


def test_cli_regplot(tmp_path):
    """regplot exports the quality/FWHM curve (gui/plot.c data)."""
    from siriltpu.testing.synth import make_sequence_frames
    state = make_state(str(tmp_path))
    frames, _, _ = make_sequence_frames(3, 64, 64, seed=9)
    for i, f in enumerate(frames):
        fits_io.write_fits(os.path.join(state.cwd, f"rp{i+1:02d}.fit"),
                           Frame(f))
    from siriltpu.io.sequence import check_seq
    check_seq(state.cwd)
    assert process_command(state, "seqload rp") == 0
    assert process_command(state, "boxselect 8 8 48 48") == 0
    assert process_command(state, "register dft") == 0
    assert process_command(state, "regplot") == 0
    out = os.path.join(state.cwd, "registration.dat")
    lines = open(out).read().strip().splitlines()
    assert lines[0].startswith("# frame quality fwhm")
    assert os.path.getsize(os.path.join(state.cwd, "registration.svg")) > 500
    assert len(lines) == 4  # header + 3 frames


def test_siril_cfg_import(tmp_path):
    """A reference ~/.siril/siril.cfg (libconfig, initfile.c) imports
    into Settings — the switch-over path for existing Siril users."""
    from siriltpu.cli.main import make_state
    from siriltpu.core.config import from_siril_cfg

    cfg = tmp_path / "siril.cfg"
    cfg.write_text(
        'working-directory = "/data/astro";\n'
        "debayer-settings :\n{\n  ser_use_bayer_header = true;\n"
        "  pattern = 2;\n  compatibility = false;\n  inter = 2;\n};\n"
        "prepro-settings :\n{\n  cfa = true;\n};\n"
        "stacking-settings :\n{\n  method = 1;\n  rejection = 4;\n"
        "  normalisation = 3;\n  maxmem = 0.75;\n};\n"
        "photometry-settings :\n{\n  gain = 2.5;\n"
        "  inner-radius = 15.0;\n  outer-radius = 25.0;\n};\n"
        "misc-settings :\n{\n  swap_directory = \"/var/tmp\";\n"
        "  extension = \".fits\";\n};\n")
    s = from_siril_cfg(str(cfg))
    assert s.debayer_pattern == "GBRG" and s.debayer_method == "vng"
    assert s.stack_method == "mean"
    assert s.stack_rejection == "winsorized"
    assert s.stack_normalization == "additive_scaling"
    assert s.stack_memory_percent == 0.75
    assert (s.phot_gain, s.phot_inner, s.phot_outer) == (2.5, 15.0, 25.0)
    assert s.fits_extension == "fits" and s.swap_dir == "/var/tmp"
    # the CLI -i flag routes .cfg files through the importer
    st = make_state(str(tmp_path), str(cfg))
    assert st.settings.stack_rejection == "winsorized"


def test_map_pressure_relief():
    """map_count reads this process's mapping table; a zero-threshold
    relieve purges jax's executable caches (the guard that keeps long
    processes under the kernel's vm.max_map_count — each loaded XLA:CPU
    executable pins ~3 code mappings until collected)."""
    import jax
    import jax.numpy as jnp

    from siriltpu.utils.hostmem import map_count, relieve_map_pressure

    n0 = map_count()
    assert n0 > 100  # a live jax process holds at least hundreds

    # create a few distinct executables, then force a purge
    for i in range(5):
        jax.jit(lambda x, i=i: (x + i).sum())(jnp.ones((4,)))
    assert relieve_map_pressure(frac=0.0) is True
    # under the real threshold, a freshly purged process does not purge
    assert relieve_map_pressure() is False
