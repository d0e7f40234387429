"""Build + load the native C++ component library.

All sources under ``siril-0.9/native/*.cpp`` compile into one
``libsirilnative.so`` (g++, on demand, cached by mtime). Mirrors the
reference's C++ subsystems (src/io/avi_pipp, src/opencv — SURVEY §2.8):
the device compute path is JAX/Pallas, but runtime components that the
reference keeps native stay native here too (AVI writer, lossless-JPEG
DNG decoder).
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsirilnative.so")
# film_codec.cpp links against the system libav* stack and builds into
# its own .so, so the core native components never depend on ffmpeg
_FILM_SOURCES = ("film_codec.cpp",)
_FILM_LIB_PATH = os.path.join(_NATIVE_DIR, "libsirilfilm.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_film_lib: Optional[ctypes.CDLL] = None
_film_build_failed = False


def _build_and_load(sources, lib_path, extra_args=()):
    stale = (not os.path.exists(lib_path) or any(
        os.path.getmtime(lib_path) < os.path.getmtime(s)
        for s in sources))
    if stale:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", *sources,
                        "-o", lib_path, *extra_args], check=True,
                       capture_output=True)
    return ctypes.CDLL(lib_path)


def load_native() -> Optional[ctypes.CDLL]:
    """Return the shared native library, compiling it if stale.
    None when no compiler is available (callers fall back to Python)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    sources = sorted(
        s for s in glob.glob(os.path.join(_NATIVE_DIR, "*.cpp"))
        if os.path.basename(s) not in _FILM_SOURCES)
    try:
        _lib = _build_and_load(sources, _LIB_PATH)
    except (subprocess.CalledProcessError, OSError):
        _build_failed = True
    return _lib


def load_film_native() -> Optional[ctypes.CDLL]:
    """The libav-backed film codec bridge (H.264/VP9/... decode, MP4/
    WEBM encode — the mp4_output.c / ffms2 films.c replacement). None
    when libavformat/libavcodec are not installed on this system."""
    global _film_lib, _film_build_failed
    if _film_lib is not None or _film_build_failed:
        return _film_lib
    sources = [os.path.join(_NATIVE_DIR, s) for s in _FILM_SOURCES]
    try:
        _film_lib = _build_and_load(
            sources, _FILM_LIB_PATH,
            ("-lavformat", "-lavcodec", "-lavutil", "-lswscale"))
    except (subprocess.CalledProcessError, OSError):
        _film_build_failed = True
    return _film_lib


__all__ = ["load_native", "load_film_native"]
