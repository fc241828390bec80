"""Build and load the port's host kernels (`native/*.cpp`), and their typed
wrappers.

The sources are compiled by `g++` into one shared library with a plain C
interface, loaded with ctypes, and linked with zlib (the PNG writer). The
library goes into `native/_build/` (ignored by git) under a name that
hashes the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The flags target no particular CPU, so
a library built on one machine runs on another. `-ffp-contract=off` keeps
every float expression a separate rounding, as numpy evaluates it: the
bit-exact kernels (the darkness and gridness maps, the CAM overlay) rest
on it, and without it a compiler may fuse a multiply and an add.

Nothing here runs at import time: `library()` builds on first use, and a
failed build raises; nothing falls back to numpy.

The wrappers carry the JAX package's names and argument checks
(`ecgmm_tpu/native/__init__.py`): the hospital filter (`remove_baseline`,
`filtfilt`, `preprocess_hospital`), the digitizer (`darkness_map`,
`colmax`, `trace_centroid`, `gridness`), the heatmap (`cam_overlay`,
`png_encode`), and three the JAX package takes from Pillow:
`resize_bilinear_u8`, `resize_bicubic_u8` and `jpeg_encode`. ctypes
releases the interpreter lock for each call, and the kernels thread their
work over up to 8 cores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
         "-ffp-contract=off"]
LIBS = ["-lz"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# name -> (argument types, result type)
_SIGNATURES = {
    "ecgmm_jpeg_huffman_scan":
        ([_P, _L, _L, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
          _I, _P], _I),
    "ecgmm_jpeg_huffman_scan_strict":
        ([_P, _L, _L, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
          _I, _P], _I),
    "ecgmm_jpeg_arith_scan":
        ([_P, _L, _L, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
          _P, _P], _I),
    "ecgmm_jpeg_aritab": ([_P], _I),
    "ecgmm_jpeg_lossless_scan":
        ([_P, _L, _L, _I, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P, _P], _I),
    "ecgmm_jpeg_smooth":
        ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P], _I),
    "ecgmm_jpeg_idct": ([_P, _P, _I, _I, _P], _I),
    "ecgmm_jpeg_upsample": ([_P, _L, _L, _I, _I, _P], _I),
    "ecgmm_jpeg_ycc_rgb": ([_P, _P, _P, _L, _P], _I),
    "ecgmm_png_unfilter": ([_P, _L, _L, _I, _P], _I),
    "ecgmm_gif_lzw": ([_P, _L, _I, _P, _L, _P], _I),
    "ecgmm_bmp_rle": ([_P, _L, _L, _I, _L, _P, _L, _P], _I),
    "ecgmm_remove_baseline": ([_P, _P, _L, _L, _I], None),
    "ecgmm_filtfilt": ([_P, _P, _P, _I, _P, _P, _L, _L], None),
    "ecgmm_preprocess_hospital": ([_P, _P, _P, _I, _I, _P, _P, _L, _L], None),
    "ecgmm_digitize_darkness": ([_P, _L, _L, _I, _I, _P, _P, _P], None),
    "ecgmm_trace_sums": ([_P, _L, _L, _P, _P, _P], None),
    "ecgmm_colmax": ([_P, _L, _L, _P], None),
    "ecgmm_gridness": ([_P, _L, _L, _I, _I, _I, _P, _P], None),
    "ecgmm_cam_overlay": ([_P, _L, _L, _P, _L, _L, _F, _F, _P, _P], None),
    "ecgmm_png_encode_sub": ([_P, _L, _L, _I, _P, _L, _P], _I),
    "ecgmm_resize_bilinear_u8": ([_P, _L, _L, _I, _L, _L, _P], _I),
    "ecgmm_resize_bicubic_u8": ([_P, _L, _L, _I, _L, _L, _P], _I),
    "ecgmm_jpeg_encode": ([_P, _L, _L, _I, _P, _L, _P], _I),
    "ecgmm_jpeg_std_huffman": ([_I, _P, _P], _I),
    "ecgmm_webp_vp8": ([_P, _L, _P, _L, _I, _I, _P, _L, _P, _L], _I),
    "ecgmm_webp_vp8l": ([_P, _L, _I, _I, _P, _L, _P, _L], _I),
    "ecgmm_pnm_plain": ([_P, _L, _P, _L, _P], _L),
    "ecgmm_tiff_packbits": ([_P, _L, _P, _L], _I),
    "ecgmm_tiff_lzw": ([_P, _L, _P, _L], _I),
    "ecgmm_tiff_fax": ([_P, _L, _I, _L, _I, _L, _L, _L, _P, _P], _I),
    "ecgmm_tiff_fax_rlew": ([_P, _L, _I, _L, _L, _L, _P, _L], _I),
    "ecgmm_tiff_thunder": ([_P, _L, _L, _L, _L, _P], _I),
    "ecgmm_ycbcr_blocks": ([_P, _L, _L, _L, _I, _I, _P, _P, _P, _P, _P, _P],
                           _I),
    "ecgmm_pil_packbits": ([_P, _L, _L, _L, _P, _P], _I),
    "ecgmm_tga_rle": ([_P, _L, _I, _L, _L, _P], _I),
    "ecgmm_qoi": ([_P, _L, _I, _L, _P], _I),
    "ecgmm_zstd_strip": ([_P, _L, _P, _L, _P], _I),
    "ecgmm_j2k_tile": ([_P, _L, _P, _L, _P, _P, _L, _P, _L], _I),
    "ecgmm_j2k_mq_decode": ([_P, _L, _L, _I, _P], _I),
    "ecgmm_j2k_idwt53_line": ([_P, _L, _L, _I], _I),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(os.path.join(_HERE, f) for f in os.listdir(_HERE)
                  if f.endswith(".cpp"))


def _build(sources, path: str) -> None:
    """One g++ per source, all started together, then the link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                ["g++", *FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("g++ failed:\n" + "\n".join(errors))
        out = os.path.join(tmp, "lib.so")
        link = subprocess.run(["g++", *FLAGS, *objs, "-o", out, *LIBS],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{link.stderr}")
        os.replace(out, path)  # atomic: concurrent builds agree


def library() -> ctypes.CDLL:
    """The loaded host-kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
        for src in sources:
            with open(src, "rb") as f:
                h.update(f.read())
        path = os.path.join(BUILD_DIR,
                            f"libecgmm_host_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            _build(sources, path)
        lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def _p(x: np.ndarray) -> int:
    return x.ctypes.data


def _as2d(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float64)
    return x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)


# ---------------------------------------------------------- hospital filter


def remove_baseline(x: np.ndarray, window: int = 200) -> np.ndarray:
    """x minus its moving average (numpy 'same' alignment), float64."""
    lib = library()
    shape = np.shape(x)
    x2 = _as2d(x)
    out = np.empty_like(x2)
    lib.ecgmm_remove_baseline(_p(x2), _p(out), x2.shape[0], x2.shape[1],
                              window)
    return out.reshape(shape)


def _check_filtfilt_len(n_samples: int, n_coef: int) -> None:
    """scipy (and the C++ odd extension) require T > padlen = 3*n_coef;
    shorter rows would read out of bounds in filtfilt_one."""
    padlen = 3 * n_coef
    if n_samples <= padlen:
        raise ValueError(
            f"filtfilt needs x.shape[-1] > padlen ({padlen}); got "
            f"{n_samples}"
        )


def _coefficients(ba):
    from scipy import signal as sps

    b = np.ascontiguousarray(ba[0], np.float64)
    a = np.ascontiguousarray(ba[1], np.float64)
    if b.shape != a.shape or b.ndim != 1:
        raise ValueError("b and a must be 1-D of equal length")
    zi = np.ascontiguousarray(sps.lfilter_zi(b, a), np.float64)
    return b, a, zi


def filtfilt(ba, x: np.ndarray) -> np.ndarray:
    """scipy.signal.filtfilt(b, a, x) over the last axis (method 'pad',
    odd extension), float64; ba is (b, a) with a[0] == 1."""
    lib = library()
    b, a, zi = _coefficients(ba)
    shape = np.shape(x)
    x2 = _as2d(x)
    _check_filtfilt_len(x2.shape[1], len(b))
    out = np.empty_like(x2)
    lib.ecgmm_filtfilt(_p(b), _p(a), _p(zi), len(b), _p(x2), _p(out),
                       x2.shape[0], x2.shape[1])
    return out.reshape(shape)


def preprocess_hospital(x: np.ndarray, window: int = 200) -> np.ndarray:
    """Fused baseline removal + hospital low-pass filtfilt (the reference
    trainers' dataset.py:91-95 pipeline) over the last axis, float64,
    threaded across signals."""
    from ecgmm_torch.data.preprocess import butter_lowpass

    lib = library()
    b, a, zi = _coefficients(butter_lowpass())
    shape = np.shape(x)
    x2 = _as2d(x)
    _check_filtfilt_len(x2.shape[1], len(b))
    out = np.empty_like(x2)
    lib.ecgmm_preprocess_hospital(_p(b), _p(a), _p(zi), len(b), window,
                                  _p(x2), _p(out), x2.shape[0], x2.shape[1])
    return out.reshape(shape)


# ---------------------------------------------------------------- digitizer


def darkness_map(image: np.ndarray, bg_window: int = 25
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """serve/digitize.darkness_map fused with its per-column and per-row
    maxima, for a uint8 photo: (rel [h, w] float32, col_max [w] float32,
    row_max [h] float32), bit-exact against the numpy path."""
    lib = library()
    raw = np.asarray(image)
    if raw.dtype != np.uint8 or raw.ndim not in (2, 3):
        raise TypeError(f"expected uint8 2-D/3-D image, got {raw.dtype}")
    if raw.ndim == 3:
        # the numpy path reduces over the first 3 channels only (RGB[A])
        raw = raw[..., :3]
        c = raw.shape[-1]
        if c == 2:
            raise TypeError("2-channel images unsupported")
    else:
        c = 1
    raw = np.ascontiguousarray(raw)
    h, w = raw.shape[0], raw.shape[1]
    rel = np.empty((h, w), np.float32)
    col_max = np.empty((w,), np.float32)
    row_max = np.empty((h,), np.float32)
    lib.ecgmm_digitize_darkness(_p(raw), h, w, c, bg_window, _p(rel),
                                _p(col_max), _p(row_max))
    return rel, col_max, row_max


def colmax(rel: np.ndarray) -> np.ndarray:
    """Per-column maxima of a darkness map, (w,) float32."""
    lib = library()
    rel = np.ascontiguousarray(rel, np.float32)
    h, w = rel.shape
    out = np.empty((w,), np.float32)
    lib.ecgmm_colmax(_p(rel), h, w, _p(out))
    return out


def trace_centroid(rel: np.ndarray, col_frac: float, floor: float,
                   col_max: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """serve/digitize.extract_trace's core over a darkness map: (centroid
    [w] float32, valid [w] bool). The per-column ink threshold and the
    valid mask are computed here with numpy (its float32 promotion, so
    they are bit-identical to the numpy path); only the h x w weighted
    sums run in C++, accumulated in float64."""
    lib = library()
    rel = np.ascontiguousarray(rel, np.float32)
    h, w = rel.shape
    if col_max is None:
        col_max = np.empty((w,), np.float32)
        lib.ecgmm_colmax(_p(rel), h, w, _p(col_max))
    else:
        col_max = np.ascontiguousarray(col_max, np.float32)
    thr = np.ascontiguousarray(np.maximum(floor, col_frac * col_max),
                               np.float32)
    wsum = np.empty((w,), np.float64)
    wrow = np.empty((w,), np.float64)
    lib.ecgmm_trace_sums(_p(rel), h, w, _p(thr), _p(wsum), _p(wrow))
    valid = (col_max >= floor) & (wsum > 0)
    centroid = np.where(valid, wrow / np.maximum(wsum, 1e-6),
                        0.0).astype(np.float32)
    return centroid, valid


def gridness(image: np.ndarray, pool: int = 1, bg_window: int = 32
             ) -> Tuple[np.ndarray, np.ndarray]:
    """serve/digitize's gridness computation for a uint8 RGB[A] photo:
    (gridness float32 [h//pool, w//pool], pooled brightness uint8 of the
    same shape), bit-exact against the numpy `_gridness_core` path. `pool`
    is 1 (`gridness_map`) or 2 (`_grid_analysis`)."""
    lib = library()
    raw = np.asarray(image)
    if raw.dtype != np.uint8 or raw.ndim != 3 or raw.shape[-1] < 3:
        raise TypeError(
            f"expected uint8 RGB image, got {raw.dtype} ndim={raw.ndim}")
    if pool not in (1, 2):
        raise ValueError(f"pool must be 1 or 2, got {pool}")
    raw = np.ascontiguousarray(raw[..., :4])
    h, w, c = raw.shape
    hp, wp = h // pool, w // pool
    g = np.empty((hp, wp), np.float32)
    bright = np.empty((hp, wp), np.uint8)
    lib.ecgmm_gridness(_p(raw), h, w, c, pool, bg_window, _p(g), _p(bright))
    return g, bright


# ------------------------------------------------------------------ heatmap


def cam_overlay(image_u8: np.ndarray, cam: np.ndarray, lut: np.ndarray,
                alpha: float = 0.4) -> np.ndarray:
    """The CAM upsampled to the image (Pillow's bilinear on a float map)
    and blended as a jet overlay: bit-identical to
    `overlay_heatmap(image_u8, resize_bilinear_f32(cam, image_u8.shape[:2]))`.

    image_u8: (H, W, 3) uint8; cam: (ch, cw) float; lut: (256, 3) uint8."""
    lib = library()
    img = np.ascontiguousarray(image_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3) uint8, got {img.shape}")
    cam2 = np.ascontiguousarray(cam, np.float32)
    if cam2.ndim != 2:
        raise ValueError(f"cam must be 2-D, got shape {np.shape(cam)}")
    lut2 = np.ascontiguousarray(lut, np.uint8)
    if lut2.shape != (256, 3):
        raise ValueError(f"lut must be (256, 3) uint8, got {lut2.shape}")
    h, w = img.shape[:2]
    out = np.empty_like(img)
    # numpy's scalar handling: (1 - alpha) is computed in Python double,
    # then rounded once to float32 where it meets the float32 array
    lib.ecgmm_cam_overlay(_p(img), h, w, _p(cam2), cam2.shape[0],
                          cam2.shape[1], float(alpha), 1.0 - float(alpha),
                          _p(lut2), _p(out))
    return out


def _rgb_u8(rgb: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(rgb, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"rgb must be (H, W, 3) uint8, got {img.shape}")
    return img


def png_encode(rgb: np.ndarray, level: int = 1) -> bytes:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG: the Sub row filter and
    a band-parallel deflate at zlib `level`, one ordinary IDAT stream."""
    lib = library()
    img = _rgb_u8(rgb)
    h, w = img.shape[:2]
    raw = h * (1 + 3 * w)
    # deflateBound-style worst case per band (stored blocks and flush
    # markers) plus the fixed chunk overhead
    cap = raw + raw // 8 + 8 * 1024
    out = np.empty(cap, np.uint8)
    out_len = np.zeros(1, np.int64)
    rc = lib.ecgmm_png_encode_sub(_p(img), h, w, int(level), _p(out), cap,
                                  _p(out_len))
    if rc != 0:
        raise RuntimeError(f"native PNG encode failed (rc={rc})")
    return out[:int(out_len[0])].tobytes()


def png_with_text(png: bytes, text: Sequence[Tuple[str, str]]) -> bytes:
    """The PNG with a tEXt chunk (Latin-1 keyword, NUL, text) for each
    pair, after the IHDR chunk."""
    ihdr_end = 8 + 8 + 13 + 4  # signature, IHDR length/type, data, CRC
    chunks = b""
    for key, value in text:
        body = b"tEXt" + key.encode("latin-1") + b"\0" + value.encode(
            "latin-1", "replace")
        chunks += (struct.pack(">I", len(body) - 4) + body
                   + struct.pack(">I", zlib.crc32(body)))
    return png[:ihdr_end] + chunks + png[ihdr_end:]


def jpeg_encode(rgb: np.ndarray, quality: int = 85) -> bytes:
    """An (H, W, 3) uint8 image as the bytes of Pillow's
    `Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)`:
    baseline, 4:2:0, the Annex K tables (`native/jpegenc.cpp`)."""
    lib = library()
    img = _rgb_u8(rgb)
    h, w = img.shape[:2]
    if not (1 <= h <= 65535 and 1 <= w <= 65535):
        raise ValueError(f"a JPEG holds 1 to 65535 rows and columns, got "
                         f"{img.shape[:2]}")
    # at most 208 bytes of entropy-coded data per block before stuffing
    # (416 after), 6 blocks per 16x16 MCU, plus the markers
    cap = 416 * 6 * (-(-h // 16)) * (-(-w // 16)) + 1024
    out = np.empty(cap, np.uint8)
    out_len = np.zeros(1, np.int64)
    rc = lib.ecgmm_jpeg_encode(_p(img), h, w, int(quality), _p(out), cap,
                               _p(out_len))
    if rc != 0:
        raise RuntimeError(f"native JPEG encode failed (rc={rc})")
    return out[:int(out_len[0])].tobytes()


# ------------------------------------------------------------------- resize


def resize_bilinear_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize((w, h), BILINEAR)` for an
    (H, W, C) uint8 image, bit for bit (`native/resize.cpp`)."""
    return _resize_u8(img, hw, "ecgmm_resize_bilinear_u8")


def resize_bicubic_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize((w, h))` (Pillow's default filter,
    BICUBIC) for an (H, W, C) uint8 image, bit for bit
    (`native/resize.cpp`)."""
    return _resize_u8(img, hw, "ecgmm_resize_bicubic_u8")


def _resize_u8(img: np.ndarray, hw: Tuple[int, int], entry: str
               ) -> np.ndarray:
    lib = library()
    src = np.ascontiguousarray(img, np.uint8)
    if src.ndim != 3 or src.shape[0] < 1 or src.shape[1] < 1:
        raise ValueError(f"img must be (H, W, C) uint8, got {src.shape}")
    oh, ow = int(hw[0]), int(hw[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"output size must be positive, got {hw}")
    out = np.empty((oh, ow, src.shape[2]), np.uint8)
    getattr(lib, entry)(_p(src), src.shape[0], src.shape[1], src.shape[2],
                        oh, ow, _p(out))
    return out
