"""Host allocator tuning for large-array workloads.

glibc munmaps every freed large buffer, so on a host with slow
first-touch page faulting each fresh 50-200 MB NumPy temporary
re-faults its pages and a single statistics pass can cost far more than
its arithmetic.

``retain_heap()`` turns off glibc's mmap path for large allocations
(M_MMAP_MAX=0) and heap trimming (M_TRIM_THRESHOLD=-1), so big blocks
come from the sbrk heap and their pages stay resident across
free/alloc cycles — first-touch is paid once per process.

No effect (and harmless) on non-glibc platforms.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_done = False


def retain_heap() -> bool:
    """Keep freed large blocks on the heap instead of munmapping them.
    Returns True if mallopt was reachable and accepted both knobs."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_MAX, 0)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, -1)
        _done = bool(ok1) and bool(ok2)
    except (OSError, AttributeError):
        _done = False
    return _done


_MAP_LIMIT: int | None = None


def _max_map_count() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530  # the kernel default


def map_count() -> int:
    """Number of memory mappings this process holds (0 if unreadable)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(buf.count(b"\n")
                       for buf in iter(lambda: f.read(1 << 20), b""))
    except OSError:
        return 0


def relieve_map_pressure(frac: float = 0.7) -> bool:
    """Drop jax's executable caches when this process nears the kernel's
    ``vm.max_map_count`` mapping limit. Returns True when a purge ran.

    Every loaded XLA:CPU executable holds ~3 anonymous code mappings
    (r-xp/r--p/rw-p) that are released only when the executable is
    garbage-collected, and jax's in-memory jit caches keep every
    executable alive for the life of the process. A long-running
    process that compiles many distinct programs (thousands of frames
    through many differently-shaped stages — or a full test session)
    therefore grows its mapping table without bound, and CROSSING the
    kernel limit does not raise: the next mmap in glibc/XLA fails and
    the failure path segfaults (observed as crashes inside compilation-
    cache serialize/deserialize once ~65k mappings accumulate).
    ``jax.clear_caches()`` releases the executables (verified: 1399 →
    502 mappings after clearing 300 jits); with the persistent
    compilation cache enabled the subsequent recompiles are disk hits,
    so periodic purging costs little. Call this from long-running
    loops (the sequence engine does, per chunk)."""
    global _MAP_LIMIT
    if _MAP_LIMIT is None:
        _MAP_LIMIT = _max_map_count()
    n = map_count()
    if n == 0 or n < frac * _MAP_LIMIT:
        return False
    import jax
    jax.clear_caches()
    return True


__all__ = ["retain_heap", "map_count", "relieve_map_pressure"]
