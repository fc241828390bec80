"""Host side of one serving request (port of `ecgmm_tpu/serve/request.py`).

`prepare_inputs` turns the strip photo and questionnaire into model
inputs the way training does (digitize -> train-identical filtering ->
model-resolution resize -> clinical vector); `assemble_response` turns
the device outputs into the ResultScreen response
(`Groove/app/(tabs)/ResultScreen.tsx:26-56`).

The host work runs the native kernels (`ecgmm_torch/native/`, C++ built
by g++ at first use), as the JAX request does where its own build
succeeds: the digitizer, the hospital filter, the CAM overlay and the PNG
writer are ports of the JAX package's kernels; the model-resolution
resize and the JPEG heatmap, which the JAX request takes from Pillow, are
C++ that writes Pillow's bytes (`native/resize.cpp`, `native/jpegenc.cpp`).
ctypes releases the interpreter lock for each kernel, so the HTTP
handler threads overlap their host work. Nothing falls back to numpy: a
failed build raises.

The numpy versions stay here as the plain versions the tests and
`chip_smoke.py` hold the kernels against: `resize_bilinear_u8` and
`resize_bilinear_f32` copy Pillow's separable BILINEAR resample (its
coefficient precomputation, its 22-bit fixed point for 8-bit images, its
double accumulation for float images, horizontal pass first), and
`encode_png` writes an 8-bit RGB PNG with zlib at level 1.
"""

from __future__ import annotations

import base64
import math
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from ecgmm_torch import native
from ecgmm_torch.data.preprocess import preprocess_hospital
from ecgmm_torch.explain.gradcam import _jet_lut
from ecgmm_torch.explain.shap_fusion import modality_contributions
from ecgmm_torch.serve import digitize as digitize_mod
from ecgmm_torch.serve.report import rule_based_report
from ecgmm_torch.serve.wire import BadRequest, _sex_from_questionnaire

HEATMAP_FORMATS = ("png", "jpeg", "cam")
JPEG_QUALITY = 85  # the JAX request's Pillow save
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the bilinear filter over a full box:
    (first source index (out,), normalised weights (out, ksize) float64,
    ksize). The filter's support widens by the downscale factor; weights
    past a row's last tap are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    n_taps = xmax - xmin
    taps = np.arange(ksize)
    pos = (((xmin[:, None] + taps[None, :]).astype(np.float64)
            - center[:, None]) + 0.5) * (1.0 / filterscale)
    w = np.where(np.abs(pos) < 1.0, 1.0 - np.abs(pos), 0.0)
    w = np.where(taps[None, :] < n_taps[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # Pillow sums the taps in order
        ww += w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    return xmin, w, ksize


def _resample_axis_u8(img: np.ndarray, out_size: int, axis: int
                      ) -> np.ndarray:
    in_size = img.shape[axis]
    xmin, w, ksize = _bilinear_coeffs(in_size, out_size)
    k = np.floor(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, ...)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for x in range(ksize):
        kx = k[:, x].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[idx[:, x]] * kx
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize((w, h), BILINEAR)` for an (H, W, 3)
    uint8 image, in numpy."""
    out = _resample_axis_u8(img, hw[1], axis=1)  # horizontal pass first
    return _resample_axis_u8(out, hw[0], axis=0)


def _resample_axis_f32(img: np.ndarray, out_size: int, axis: int
                       ) -> np.ndarray:
    in_size = img.shape[axis]
    xmin, w, ksize = _bilinear_coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    acc = np.zeros((out_size,) + src.shape[1:], np.float64)
    for x in range(ksize):
        kx = w[:, x].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[idx[:, x]] * kx
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def resize_bilinear_f32(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img, mode="F").resize((w, h), BILINEAR)` for a
    2-D float32 map, in numpy."""
    out = _resample_axis_f32(np.asarray(img, np.float32), hw[1], axis=1)
    return _resample_axis_f32(out, hw[0], axis=0)


def encode_png(rgb: np.ndarray, level: int = 1) -> bytes:
    """An (H, W, 3) uint8 image as PNG bytes (8-bit RGB, no filtering)."""
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = np.ascontiguousarray(rgb).reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", crc)

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + chunk(b"IEND", b"")
    )


def check_heatmap_format(heatmap_format: str) -> None:
    if heatmap_format not in HEATMAP_FORMATS:
        raise BadRequest(
            f"heatmap_format must be one of {HEATMAP_FORMATS}, got "
            f"{heatmap_format!r}"
        )


def prepare_inputs(pipe, image_u8: np.ndarray, questionnaire: Dict
                   ) -> Tuple:
    """Digitize + preprocess one request into model-ready arrays.

    Returns (img_norm (1, H, W, 3) f32, sig (1, T) f32, clin (1, F) f32,
    mv, dig_info, age, image_u8), where image_u8 is the located strip
    crop when the digitizer found one: the image branch and the Grad-CAM
    overlay both see the strip, not what it was photographed on."""
    mv, dig_info = digitize_mod.digitize_lead2_info(
        image_u8, target_len=pipe.signal_len
    )
    if dig_info["crop"] is not None:
        y0, y1, x0, x1 = dig_info["crop"]
        image_u8 = image_u8[y0:y1, x0:x1]

    sig = mv[None, :]
    if pipe.ecg_scaler is not None:
        sig = pipe.ecg_scaler.transform(sig)
    sig = preprocess_hospital(np.asarray(sig, np.float32))

    img_u8 = native.resize_bilinear_u8(np.asarray(image_u8, np.uint8),
                                       pipe.img_hw)[None]
    img_norm = img_u8.astype(np.float32) / 127.5 - 1.0

    def qnum(key, default):
        v = questionnaire.get(key, default)
        if v is None or v == "":
            return float(default)
        try:
            return float(v)
        except (TypeError, ValueError):
            raise BadRequest(
                f"questionnaire field {key!r} must be numeric, got {v!r}"
            )

    age = qnum("age", 60)
    wt = qnum("weight", 70)
    # Unknown features sit at the scaler's training mean (0 after
    # standardisation), the neutral value.
    raw = np.zeros((1, pipe.n_clin), np.float32)
    if (pipe.clinical_scaler is not None
            and np.size(pipe.clinical_scaler.mean) == pipe.n_clin):
        raw[:] = np.asarray(pipe.clinical_scaler.mean, np.float32)
    raw[0, 0] = age
    if pipe.n_clin > 1:
        raw[0, 1] = wt
    clin = raw
    if pipe.clinical_scaler is not None:
        clin = np.asarray(pipe.clinical_scaler.transform(raw), np.float32)
    return img_norm, sig, clin, mv, dig_info, age, image_u8


def render_heatmap(image_u8: np.ndarray, cam_small: np.ndarray,
                   heatmap_format: str) -> Tuple[str, object, str]:
    """Upsample the feature-map-native CAM to the strip on the host and
    blend it as a jet overlay (`native.cam_overlay`), encoded as PNG at
    zlib level 1 ("png") or as JPEG at quality 85 ("jpeg"), or return the
    raw CAM grid for client-side rendering ("cam").

    Returns (heatmap_b64, heatmap_cam, heatmap_mime)."""
    if heatmap_format == "cam":
        return "", cam_small.tolist(), "image/png"
    overlay = native.cam_overlay(image_u8, cam_small, _jet_lut())
    if heatmap_format == "jpeg":
        data = native.jpeg_encode(overlay, JPEG_QUALITY)
        mime = "image/jpeg"
    else:
        data = native.png_encode(overlay, level=1)
        mime = "image/png"
    return base64.b64encode(data).decode(), None, mime


def assemble_response(pipe, *, mv, dig_info, image_u8, questionnaire,
                      probs, pred, cam, attr, ca_a, age,
                      heatmap_format) -> Dict:
    """Device outputs -> the ResultScreen response JSON."""
    label = "Abnormal" if pred == 1 else "Normal"
    cam_small = np.asarray(cam, np.float32)[0]
    heatmap_b64, heatmap_cam, heatmap_mime = render_heatmap(
        image_u8, cam_small, heatmap_format)

    contrib = modality_contributions(np.asarray(attr), pipe.dims)
    clin_pct = float(contrib["Clinical_%"][0])
    # split the clinical chunk between age and wt by each input
    # dimension's integrated-gradients attribution (not 50/50)
    ca = np.abs(np.asarray(ca_a))
    total = float(ca.sum())
    share = ca / total if total > 0 else np.full(ca.shape, 1.0 / len(ca))
    feature_importance = {
        "image": float(contrib["Image_%"][0]),
        "signal": float(contrib["Signal_%"][0]),
        "age": clin_pct * float(share[0]),
        "wt": clin_pct * float(share[1]),
    }

    gpt_result = rule_based_report(
        mv, abnormal=(pred == 1), probability=float(probs[pred]),
        age=age, sex=_sex_from_questionnaire(questionnaire),
    )

    resp = {
        "label": label,
        "probability": float(probs[pred]),
        "ecg_signal": [
            {"Voltage (mV)": float(v)}
            for v in mv[:: max(1, len(mv) // 500)]
        ],
        "heatmap": heatmap_b64,
        "feature_importance": feature_importance,
        "gpt_result": gpt_result,
        "digitization": dig_info,
    }
    if heatmap_format == "jpeg":
        resp["heatmap_mime"] = heatmap_mime
    if heatmap_cam is not None:
        resp["heatmap_cam"] = heatmap_cam
    return resp
