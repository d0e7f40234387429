"""siriltpu — an accelerator-native (JAX/XLA/Pallas) astronomical image-processing framework.

Re-implements the capabilities of Siril 0.9 (reference: pXlor/Siril-0.9):
conversion, calibration (preprocessing), registration (alignment), stacking,
and enhancement of astronomical image sequences — redesigned as device programs:

- pure-functional core: frames are ``uint16[C, H, W]`` arrays (channel-planar,
  bottom-to-top row order, matching Siril's FITS convention,
  reference src/core/siril.h:439-442);
- per-frame math batched with ``vmap``, streaming accumulation with
  ``lax.scan``, multi-device scale-out with ``shard_map`` over a
  ``jax.sharding.Mesh`` (frames × rows axes);
- host layer (Python/NumPy) for FITS/SER/.seq I/O, CLI, orchestration.

The reference mutates global state (``gfit``, ``com.seq``) under one worker
thread; siriltpu is arrays-in/arrays-out with the same observable semantics.
"""

__version__ = "0.2.0"

from siriltpu.core.frame import Frame, ImStats, Rect  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (keeps `import siriltpu` light)."""
    import importlib

    api = {
        "statistics": ("siriltpu.ops.stats", "statistics"),
        "stack_frames": ("siriltpu.stacking.api", "stack_frames"),
        "stack_sequence": ("siriltpu.stacking.api", "stack_sequence"),
        "register_shift_dft": ("siriltpu.registration.translation",
                               "register_shift_dft"),
        "register_ecc": ("siriltpu.registration.translation", "register_ecc"),
        "register_onestar": ("siriltpu.registration.onestar",
                             "register_onestar"),
        "register_global_star": ("siriltpu.registration.global_star",
                                 "register_global_star"),
        "peaker": ("siriltpu.ops.starfind", "peaker"),
        "read_fits": ("siriltpu.io.fits", "read_fits"),
        "write_fits": ("siriltpu.io.fits", "write_fits"),
        "check_seq": ("siriltpu.io.sequence", "check_seq"),
        "seq_preprocess": ("siriltpu.pipelines.preprocess", "seq_preprocess"),
        "register_and_stack": ("siriltpu.pipelines.register_stack",
                               "register_and_stack"),
        "autostretch": ("siriltpu.ops.histogram_ops", "autostretch"),
        "read_raw": ("siriltpu.io.raw", "read_raw"),
        "read_raw_cfa": ("siriltpu.io.raw", "read_raw_cfa"),
        "convert_dir": ("siriltpu.io.conversion", "convert_dir"),
        "export_sequence": ("siriltpu.io.export", "export_sequence"),
        "film_sequence": ("siriltpu.io.films", "film_sequence"),
        "init_distributed": ("siriltpu.parallel.multihost",
                             "init_distributed"),
        "make_multihost_register_stack": ("siriltpu.parallel.multihost",
                                          "make_multihost_register_stack"),
        "enable_compilation_cache": ("siriltpu.utils.compcache",
                                     "enable_compilation_cache"),
    }
    if name in api:
        mod, attr = api[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'siriltpu' has no attribute {name!r}")
