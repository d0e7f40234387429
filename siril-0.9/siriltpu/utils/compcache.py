"""Persistent XLA compilation cache.

Every siriltpu entry point (CLI, benchmarks, the chip smoke run) pays a
first-compile penalty per kernel per process without this. Enabling
``jax_compilation_cache_dir`` persists compiled executables on disk so a
cold *process* is no longer a cold *cache*.

Placement: ``JAX_COMPILATION_CACHE_DIR``, when set, is used exactly as
given. Otherwise the cache lives at ``.jax_cache/`` in the checkout
(listed in ``.gitignore``): the same path on every machine, because the
path is part of what a later process has to find again. Only CPU
artifacts go one level deeper, into a directory keyed on the host's CPU
features (see :func:`_host_key`).

This replaces nothing in the reference (C is ahead-of-time compiled);
it is XLA hygiene.
"""

from __future__ import annotations

import hashlib
import os
import platform
import sys

_ENABLED = ""

#: fixed in-checkout location (siril-0.9/siriltpu/utils -> checkout root)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), ".jax_cache")


def _host_key(isa_token: str = "") -> str:
    """Short hash identifying this host's CPU feature set.

    XLA:CPU AOT-compiles with the *compiling* machine's CPU features
    baked in; loading such an artifact on a host with different
    features (e.g. ``+prefer-no-scatter`` vs not) silently changes
    numerics or errors in ``cpu_aot_loader``. Keying the CPU cache
    directory on (machine, flags-from-/proc/cpuinfo, effective max-ISA
    cap) guarantees a cross-machine cache — or one compiled under a
    different ISA cap — is simply a different directory, never a
    poisoned one.
    """
    parts = [platform.machine(), platform.system(), isa_token]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
                if line.startswith("model name"):
                    parts.append(line.split(":", 1)[1].strip())
    except OSError:
        parts.append(platform.processor())
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


def _backend_initialized() -> bool:
    """True when a jax backend is already live (XLA_FLAGS consumed)."""
    if "jax" not in sys.modules:
        return False
    try:
        from jax._src import xla_bridge
        return bool(getattr(xla_bridge, "_backends", None))
    except Exception:
        return True  # cannot tell: be conservative


def _cap_cpu_isa() -> str:
    """Cap XLA:CPU codegen at AVX2 and return the ISA token for the CPU
    cache key.

    XLA:CPU with AVX-512 available compiles with +prefer-no-scatter /
    +prefer-no-gather tuning flags baked into the serialized AOT
    executable; the loader's host-feature check does not know those
    pseudo-features, so EVERY warm-cache load logs a cpu_aot_loader
    feature-mismatch error — even on the machine that compiled it.
    Capping CPU codegen at AVX2 produces feature sets the loader accepts
    cleanly. The flag only affects the CPU backend.

    The append only takes effect if XLA has not consumed XLA_FLAGS yet
    (that happens at BACKEND INIT, not jax import); when a backend is
    already live the effective ISA is unknowable, so the cache key gets
    a distinct token (artifacts compiled with and without the cap must
    never share a directory)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_max_isa" in flags:
        import re
        m = re.search(r"xla_cpu_max_isa=(\S+)", flags)
        return f"isa-{m.group(1) if m else 'preset'}"
    if _backend_initialized():
        import warnings
        warnings.warn(
            "enable_compilation_cache() called after the jax backend "
            "initialized: the xla_cpu_max_isa=AVX2 cap cannot apply "
            "to this process; using a separate cache key", stacklevel=3)
        return "isa-preinit-unknown"
    os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_max_isa=AVX2").strip()
    return "isa-AVX2"


def enable_compilation_cache() -> str:
    """Point JAX at the persistent on-disk compilation cache and return
    its directory. Idempotent.

    Call it before the first ``jax.jit`` trace; it initializes the JAX
    backend to learn whether this process compiles for the CPU. Also
    applies the host allocator tuning (utils/hostmem.retain_heap): every
    siriltpu entry point wants both, and this is the one call they all
    share.
    """
    from siriltpu.utils.hostmem import retain_heap
    retain_heap()
    global _ENABLED
    if _ENABLED:
        return _ENABLED
    isa_token = _cap_cpu_isa()

    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        if jax.default_backend() == "cpu":
            cache_dir = os.path.join(cache_dir,
                                     "cpu-" + _host_key(isa_token))
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache everything: siriltpu kernels are small but numerous, and the
    # default thresholds (>1 s compile, >4 KB executable) skip most of
    # them while the per-kernel win is the whole point here.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _ENABLED = cache_dir
    return cache_dir
