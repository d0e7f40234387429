"""Test harness configuration.

Tests run on the JAX CPU backend with 8 virtual devices so multi-device
sharding paths (mesh over frames × rows) execute without accelerator
hardware — SURVEY §4(d). Must set env BEFORE jax import. Tests marked
``gpu`` need an NVIDIA GPU; they skip here and ``chip_smoke.py`` runs them
on the card.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "siril-0.9")
if _PKG not in sys.path:
    sys.path.insert(0, _PKG)

# persistent compilation cache: repeat test runs skip XLA recompiles
from siriltpu.utils.compcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import pytest  # noqa: E402

from siriltpu.utils.hostmem import relieve_map_pressure  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run on the card by "
        "chip_smoke.py; skipped elsewhere)")


@pytest.fixture(autouse=True)
def _map_pressure_guard():
    """The full suite jits ~19k distinct programs; every loaded XLA:CPU
    executable pins ~3 anonymous code mappings, so one pytest process
    crosses the kernel's vm.max_map_count (65530) around test ~380 and
    SEGFAULTS in whatever mmaps next (observed inside the jax
    compilation cache's serialize/deserialize). Purge jax's executable
    caches whenever the mapping table nears the limit — recompiles are
    persistent-cache disk hits, so the purge costs seconds, not
    minutes."""
    yield
    relieve_map_pressure()
