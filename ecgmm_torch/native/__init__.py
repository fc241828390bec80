"""Build and load the port's host kernels (`native/*.cpp`).

The sources are compiled by `g++` into one shared library with a plain C
interface, loaded with ctypes. The library goes into `native/_build/`
(ignored by git) under a name that hashes the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
flags target no particular CPU, so a library built on one machine runs on
another.

Nothing here runs at import time: `library()` builds on first use, and a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "ecgmm_jpeg_decode_scan":
        [_P, _L, _L, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "ecgmm_jpeg_idct": [_P, _P, _I, _I, _P],
    "ecgmm_jpeg_upsample": [_P, _L, _L, _I, _I, _P],
    "ecgmm_jpeg_ycc_rgb": [_P, _P, _P, _L, _P],
    "ecgmm_png_unfilter": [_P, _L, _L, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(os.path.join(_HERE, f) for f in os.listdir(_HERE)
                  if f.endswith(".cpp"))


def library() -> ctypes.CDLL:
    """The loaded host-kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        h = hashlib.sha256(" ".join(FLAGS).encode())
        for src in sources:
            with open(src, "rb") as f:
                h.update(f.read())
        path = os.path.join(BUILD_DIR,
                            f"libecgmm_host_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                out = os.path.join(tmp, "lib.so")
                proc = subprocess.run(["g++", *FLAGS, *sources, "-o", out],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed:\n{proc.stderr}")
                os.replace(out, path)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
