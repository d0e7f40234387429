"""Wall-clock timing (the reference's gettimeofday + show_time pairs
around every long operation, SURVEY §5.1) and an optional JAX profiler
hook for device traces.
"""

from __future__ import annotations

import contextlib
import time


def format_time(seconds: float) -> str:
    """show_time formatting (core/utils.c)."""
    if seconds >= 3600:
        return f"{seconds / 3600:.2f} h"
    if seconds >= 60:
        return f"{seconds / 60:.2f} min"
    if seconds >= 1:
        return f"{seconds:.2f} s"
    return f"{seconds * 1000:.2f} ms"


@contextlib.contextmanager
def timed(label: str, log=print):
    t0 = time.perf_counter()
    yield
    log(f"Execution time [{label}]: {format_time(time.perf_counter() - t0)}")


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace around a block (view with TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


__all__ = ["timed", "format_time", "device_trace"]
