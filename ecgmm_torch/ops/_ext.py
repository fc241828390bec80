"""Build and load the port's CUDA kernels (`ops/csrc/*.cu`).

Each source is compiled by `nvcc` for `sm_90a` into an object file, all at
once in parallel, and the objects are linked into one shared library with
a plain C interface, loaded with ctypes. The sources include no PyTorch
header, so a build takes seconds. The library goes into `ops/_build/`
(ignored by git) under a name that hashes the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: `library()` builds on first use, and a
failed build raises. There is no fallback to the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ecgmm_se_forward_f32": [_P] * 8 + [_I] * 6 + [_P],
    "ecgmm_se_forward_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "ecgmm_se_backward_f32": [_P] * 13 + [_I] * 6 + [_P],
    "ecgmm_se_backward_bf16": [_P] * 13 + [_I] * 6 + [_P],
    "ecgmm_attention_fusion_forward":
        [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
    "ecgmm_attention_fusion_backward":
        [_P] * 15 + [_I] * 9 + [_P],
    "ecgmm_focal_loss_forward_i32":
        [_P] * 5 + [_I] * 5 + [ctypes.c_float] * 2 + [_P],
    "ecgmm_focal_loss_forward_i64":
        [_P] * 5 + [_I] * 5 + [ctypes.c_float] * 2 + [_P],
    "ecgmm_focal_loss_backward_i32":
        [_P] * 7 + [_I] * 5 + [ctypes.c_float] * 2 + [_P],
    "ecgmm_focal_loss_backward_i64":
        [_P] * 7 + [_I] * 5 + [ctypes.c_float] * 2 + [_P],
}


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME to the CUDA toolkit to build "
            "ecgmm_torch's kernels"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(sources, lib_path: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )))
        errors = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        if link.returncode != 0:
            raise RuntimeError(
                "nvcc link failed:\n" + link.stdout.decode(errors="replace")
            )
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from `ops/csrc/` on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            with open(src, "rb") as f:
                h.update(f.read())
        lib_path = os.path.join(
            BUILD_DIR, f"libecgmm_kernels_{h.hexdigest()[:16]}.so"
        )
        if not os.path.exists(lib_path):
            _build(sources, lib_path)
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch_target(device: torch.device):
    """(context, stream) for a launch on `device`: the context makes
    `device` current only where it is not already, and the stream is
    PyTorch's current stream there as an int for ctypes, read without
    building a Python stream object. Both costs recur on every launch of
    a host-bound step (chip_smoke.py's `host_us` reads them)."""
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        return contextlib.nullcontext(), \
            torch._C._cuda_getCurrentRawStream(current)
    return torch.cuda.device(index), torch._C._cuda_getCurrentRawStream(index)


def check(status: int, name: str) -> None:
    """Raise on a failed launch (the C entry points return
    cudaGetLastError(); a refused launch never runs and a later
    synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
