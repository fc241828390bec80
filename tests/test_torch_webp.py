"""The port's WebP decoder (`serve/imdecode.py`, `native/webpdec.cpp`)
against the JAX handler's Pillow path, bit for bit: `decode_upload(b)`
equals `np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`
and `decode_image(b)` equals `Image.open(b).convert("RGB")`, for lossy
(VP8), lossless (VP8L), alpha (ALPH), extended (VP8X, EXIF, XMP) and
animated (ANIM, ANMF) files, and the port refuses exactly the files
Pillow refuses.

The files are made here with Pillow's WebP encoder from the committed
fixtures (decoded by the port) and from numpy seeds. Pillow's encoder
sets neither the simple loop filter, the sharpness, the filter deltas,
the segment delta mode nor more than one token partition, so
`_transcode` rewrites a file's VP8 header with them: it decodes the
first partition (and the token partition) symbol by symbol with each
symbol's probability and encodes the symbols again around the changed
fields. The VP8 tables it needs are read from the decoder's source,
whose tables the lossy cases hold against Pillow.
"""

from __future__ import annotations

import io
import os
import re
import struct

import numpy as np
import pytest
from PIL import Image, ImageOps

from ecgmm_torch.serve import imdecode
from ecgmm_torch.serve.imdecode import decode_image, decode_upload
from ecgmm_torch.serve.wire import BadRequest

FIXTURES = os.path.join(os.path.dirname(imdecode.__file__), "fixtures")
WEBPDEC = os.path.join(os.path.dirname(imdecode.native.__file__),
                       "webpdec.cpp")


def pillow(data: bytes) -> np.ndarray:
    """The JAX handler's expression (`ecgmm_tpu/serve/http.py`)."""
    return np.asarray(ImageOps.exif_transpose(
        Image.open(io.BytesIO(data))).convert("RGB"))


def assert_bit_equal(data: bytes) -> None:
    want = pillow(data)
    got = decode_upload(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    im = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(decode_image(data),
                                  np.asarray(im.convert("RGB")))
    if im.mode == "RGBA":  # the ALPH or VP8L alpha, decoded too
        a = imdecode._decode_webp(data, alpha=True)[3]
        np.testing.assert_array_equal(a, np.asarray(im)[:, :, 3])


def webp(img: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kwargs)
    return buf.getvalue()


@pytest.fixture(scope="module")
def strip():
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        return decode_upload(f.read())


@pytest.fixture(scope="module")
def scene():
    with open(os.path.join(FIXTURES, "scene_exif6.jpg"), "rb") as f:
        return decode_image(f.read())


# ------------------------------------------------------------ lossy, lossless


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [5, 30, 75, 95, 100])
def test_lossy_bit_equal_to_pillow(strip, scene, quality, method):
    assert_bit_equal(webp(strip[:96, 300:460], quality=quality,
                          method=method))
    assert_bit_equal(webp(scene[40:113, 10:95], quality=quality,
                          method=method))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("method", [0, 6])
def test_lossless_bit_equal_to_pillow(strip, method, exact):
    """RGB and RGBA; `exact` keeps the RGB under transparent pixels."""
    rng = np.random.default_rng(method + 2 * exact)
    img = strip[:64, 500:597]
    assert_bit_equal(webp(img, lossless=True, method=method, exact=exact))
    alpha = rng.integers(0, 256, img.shape[:2], dtype=np.uint8)
    alpha[:, :30] = 0
    rgba = np.dstack([img, alpha])
    assert_bit_equal(webp(rgba, lossless=True, method=method, exact=exact))
    noise = rng.integers(0, 256, (37, 29, 4), dtype=np.uint8)
    assert_bit_equal(webp(noise, lossless=True, method=method, exact=exact))


@pytest.mark.parametrize("alpha_quality", [0, 40, 100])
def test_lossy_with_alpha_bit_equal_to_pillow(strip, alpha_quality):
    rng = np.random.default_rng(alpha_quality)
    img = strip[200:260, 100:181]
    ramp = np.linspace(0, 255, img.shape[1]).astype(np.uint8)
    alpha = np.broadcast_to(ramp, img.shape[:2]).copy()
    alpha[20:30] = rng.integers(0, 256, (10, img.shape[1]), dtype=np.uint8)
    assert_bit_equal(webp(np.dstack([img, alpha]), quality=70,
                          alpha_quality=alpha_quality))


@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (1, 40), (31, 1), (15, 16),
                                (16, 15), (33, 17)])
def test_sizes_and_odd_edges(strip, hw):
    """The fancy upsampler's first and last rows and columns."""
    h, w = hw
    img = strip[120:120 + h, 700:700 + w]
    assert_bit_equal(webp(img, quality=60))
    assert_bit_equal(webp(img, lossless=True))


def test_full_strip_size(strip):
    """250 x 2500, the reference's strips."""
    assert strip.shape == (250, 2500, 3)
    assert_bit_equal(webp(strip, quality=80))
    assert_bit_equal(webp(strip, lossless=True, method=0))


# ------------------------------------------------------------- EXIF, XMP


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations(scene, orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    data = webp(scene[:50, :70], quality=75, exif=ex.tobytes())
    assert b"VP8X" in data and b"EXIF" in data
    assert_bit_equal(data)


def test_xmp_orientation_and_exif_precedence(scene):
    img = scene[:30, :50]
    xmp = b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'
    data = webp(img, quality=75, xmp=xmp)
    assert_bit_equal(data)
    assert decode_upload(data).shape == (50, 30, 3)
    ex = Image.Exif()
    ex[0x0112] = 3
    both = webp(img, quality=75, xmp=xmp, exif=ex.tobytes())
    assert_bit_equal(both)
    assert decode_upload(both).shape == (30, 50, 3)


# ---------------------------------------------------------------- chunks


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\x00" * (
        len(payload) & 1)


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def image_chunk(data: bytes) -> bytes:
    """The VP8 or VP8L chunk of a simple file."""
    assert data[12:16] in (b"VP8 ", b"VP8L")
    return data[12:]


def anmf(x: int, y: int, w: int, h: int, frame: bytes) -> bytes:
    return chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                 + (y // 2).to_bytes(3, "little")
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little")
                 + (100).to_bytes(3, "little") + b"\x00" + frame)


def test_animation_first_frame(strip):
    frames = [Image.fromarray(strip[10 * k:50 + 10 * k, 40:110])
              for k in range(3)]
    for kwargs in ({"quality": 60}, {"lossless": True}):
        buf = io.BytesIO()
        frames[0].save(buf, format="WEBP", save_all=True,
                       append_images=frames[1:], duration=80, **kwargs)
        data = buf.getvalue()
        assert data.count(b"ANMF") == 3
        assert_bit_equal(data)


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_frame_offset_and_smaller_than_canvas(strip, lossless):
    """The first frame at (6, 4), 30 x 20 on a 48 x 40 canvas: libwebp's
    animation decoder zero-fills the canvas for a key frame, so the
    surround is black whatever the ANIM background colour."""
    frame = webp(strip[:20, 200:230], lossless=lossless, quality=70)
    second = webp(strip[30:70, 0:48], quality=70)
    anim = chunk(b"ANIM", struct.pack("<IH", 0xFF10A0E0, 0))
    body = (vp8x(0x02, 48, 40) + anim + anmf(6, 4, 30, 20,
                                                image_chunk(frame))
            + anmf(0, 0, 48, 40, image_chunk(second)))
    data = riff(body)
    assert_bit_equal(data)
    got = decode_upload(data)
    assert not got[:4].any() and not got[:, :6].any()
    np.testing.assert_array_equal(got[4:24, 6:36], decode_upload(frame))
    # the frame's size comes from its bitstream, not the ANMF fields
    assert_bit_equal(riff(vp8x(0x02, 48, 40) + anim
                          + anmf(6, 4, 3, 2, image_chunk(frame))))
    # a frame past the canvas, and an animation flag without ANIM, refused
    for bad in (riff(vp8x(0x02, 48, 40) + anim
                     + anmf(20, 24, 30, 20, image_chunk(frame))),
                riff(vp8x(0x02, 48, 40) + anmf(0, 0, 30, 20,
                                                image_chunk(frame)))):
        with pytest.raises(Exception):
            pillow(bad)
        with pytest.raises(BadRequest):
            decode_upload(bad)


def _alph(alpha: np.ndarray, filt: int) -> bytes:
    """An ALPH payload of raw (uncompressed) alpha under filter `filt`
    (0 none, 1 horizontal, 2 vertical, 3 gradient)."""
    a = alpha.astype(np.int32)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]
        if filt == 1:
            pred[1:, 0] = a[:-1, 0]
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:] = a[:-1]
        else:
            pred[1:, 0] = a[:-1, 0]
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1],
                                   0, 255)
    return bytes([filt << 2]) + ((a - pred) & 0xFF).astype(np.uint8).tobytes()


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_raw_alpha_filters(strip, filt):
    """Uncompressed ALPH data under each filter, beside a VP8 frame."""
    rng = np.random.default_rng(filt)
    img = strip[:24, 900:935]
    alpha = rng.integers(0, 256, img.shape[:2], dtype=np.uint8)
    vp8 = image_chunk(webp(img, quality=70))
    data = riff(vp8x(0x10, 35, 24) + chunk(b"ALPH", _alph(alpha, filt))
                + vp8)
    assert_bit_equal(data)
    np.testing.assert_array_equal(
        imdecode._decode_webp(data, alpha=True)[3], alpha)
    # alpha data one byte short: refused by both
    short = riff(vp8x(0x10, 35, 24)
                 + chunk(b"ALPH", _alph(alpha, filt)[:-1]) + vp8)
    with pytest.raises(Exception):
        pillow(short)
    with pytest.raises(BadRequest, match="alpha"):
        decode_upload(short)
    # without the VP8X alpha flag the ALPH chunk is ignored, even broken
    assert_bit_equal(riff(vp8x(0x00, 35, 24) + chunk(b"ALPH", b"\xff")
                          + vp8))


def test_container_rules(strip):
    img = strip[:16, :24]
    vp8 = image_chunk(webp(img, quality=50))
    vp8l = image_chunk(webp(img, lossless=True))
    ok = [
        riff(vp8x(0x00, 24, 16) + chunk(b"ICCP", b"abc") + vp8),
        riff(vp8x(0x00, 24, 16) + chunk(b"JUNK", b"12345") + vp8
             + chunk(b"JUNK", b"")),
        riff(vp8x(0x20, 24, 16) + vp8l),
        riff(vp8) + b"trailing bytes past the RIFF size",
    ]
    for data in ok:
        assert_bit_equal(data)
    bad = [
        riff(vp8x(0x00, 24, 17) + vp8),            # canvas != frame
        riff(vp8x(0x01, 24, 16) + vp8),            # unknown flag
        riff(vp8x(0x00, 24, 16) + vp8 + vp8),      # a second image
        riff(vp8x(0x00, 24, 16)),                  # no image
        riff(vp8x(0x10, 24, 16) + chunk(b"ALPH", b"\x00" * 385) + vp8l),
        riff(vp8x(0x00, 24, 16) + vp8 + b"\x00" * 5),  # a torn chunk
        riff(vp8)[:-1],                            # shorter than its RIFF
        riff(vp8x(0x00, 24, 16) + chunk(b"VP8X", b"\x00" * 10) + vp8),
    ]
    for data in bad:
        with pytest.raises(Exception):
            pillow(data)
        with pytest.raises(BadRequest):
            decode_upload(data)


def test_canvas_bomb_refused_before_allocation():
    big = riff(vp8x(0x02, 13400, 13400) + chunk(b"ANIM", b"\x00" * 6)
               + anmf(0, 0, 1, 1, image_chunk(webp(np.zeros(
                   (1, 1, 3), np.uint8), lossless=True))))
    with pytest.raises(Exception):
        pillow(big)
    with pytest.raises(BadRequest, match="decompression bomb"):
        decode_upload(big)


# ----------------------------------------------- the test-side transcoder


def _cpp_table(name: str) -> list:
    with open(WEBPDEC) as f:
        src = f.read()
    body = re.search(name + r"\[[^=]*= \{([^;]*)\};", src).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


_T = {}


def _tables():
    if not _T:
        _T["update"] = np.array(_cpp_table("kCoeffsUpdateProba")).reshape(
            4, 8, 3, 11)
        _T["proba0"] = np.array(_cpp_table("kCoeffsProba0")).reshape(
            4, 8, 3, 11)
        _T["bmodes"] = np.array(_cpp_table("kBModesProba")).reshape(10, 10, 9)
    return _T


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8,
                  -8, -9)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


class _BoolDecoder:
    """RFC 6386's boolean decoder, recording each (probability, bit)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8 | data[1]) if len(data) > 1 else 0
        self.range, self.count = 255, 0
        self.ops = []

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            b, self.range, self.value = 1, self.range - split, \
                self.value - big
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        self.ops.append((prob, b))
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.bits(n)
        return -v if self.bit(128) else v


class _BoolEncoder:
    """RFC 6386's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, prob: int, b: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit(128, (v >> i) & 1)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _optional_signed(d: _BoolDecoder, n: int):
    return d.signed(n) if d.bit(128) else None


def _parse_header(d: _BoolDecoder) -> dict:
    """The first partition's fields up to the quantisers."""
    h = {"colorspace": d.bit(128), "clamp": d.bit(128)}
    h["use_segment"] = d.bit(128)
    h["update_map"] = h["update_data"] = 0
    if h["use_segment"]:
        h["update_map"] = d.bit(128)
        h["update_data"] = d.bit(128)
        if h["update_data"]:
            h["absolute"] = d.bit(128)
            h["quant"] = [_optional_signed(d, 7) for _ in range(4)]
            h["fstrength"] = [_optional_signed(d, 6) for _ in range(4)]
        if h["update_map"]:
            h["seg_probs"] = [d.bits(8) if d.bit(128) else None
                              for _ in range(3)]
    h["simple"], h["level"], h["sharpness"] = d.bit(128), d.bits(6), \
        d.bits(3)
    h["use_lf_delta"] = d.bit(128)
    h["lf_update"] = 0
    if h["use_lf_delta"]:
        h["lf_update"] = d.bit(128)
        if h["lf_update"]:
            h["ref_delta"] = [_optional_signed(d, 6) for _ in range(4)]
            h["mode_delta"] = [_optional_signed(d, 6) for _ in range(4)]
    h["log2_parts"] = d.bits(2)
    h["base_q"] = d.bits(7)
    h["dq"] = [_optional_signed(d, 4) for _ in range(5)]
    return h


def _write_header(e: _BoolEncoder, h: dict) -> None:
    def opt(v, n):
        e.bit(128, v is not None)
        if v is not None:
            e.bits(abs(v), n)
            e.bit(128, v < 0)

    e.bit(128, h["colorspace"])
    e.bit(128, h["clamp"])
    e.bit(128, h["use_segment"])
    if h["use_segment"]:
        e.bit(128, h["update_map"])
        e.bit(128, h["update_data"])
        if h["update_data"]:
            e.bit(128, h["absolute"])
            for v in h["quant"]:
                opt(v, 7)
            for v in h["fstrength"]:
                opt(v, 6)
        if h["update_map"]:
            for v in h["seg_probs"]:
                e.bit(128, v is not None)
                if v is not None:
                    e.bits(v, 8)
    e.bit(128, h["simple"])
    e.bits(h["level"], 6)
    e.bits(h["sharpness"], 3)
    e.bit(128, h["use_lf_delta"])
    if h["use_lf_delta"]:
        e.bit(128, h["lf_update"])
        if h["lf_update"]:
            for v in h["ref_delta"] + h["mode_delta"]:
                opt(v, 6)
    e.bits(h["log2_parts"], 2)
    e.bits(h["base_q"], 7)
    for v in h["dq"]:
        opt(v, 4)


def _parse_modes(d: _BoolDecoder, h: dict, mb_w: int, mb_h: int):
    """The rest of the first partition: the probability updates, then
    each macroblock's segment, skip flag and intra modes. Returns the
    coefficient probabilities and, per macroblock, (is_i4x4, skip)."""
    t = _tables()
    d.bit(128)  # refresh_entropy_probs
    probs = t["proba0"].copy()
    for idx in np.ndindex(4, 8, 3, 11):
        if d.bit(int(t["update"][idx])):
            probs[idx] = d.bits(8)
    use_skip = d.bit(128)
    skip_p = d.bits(8) if use_skip else 0
    seg_probs = [255 if p is None else p for p in h.get("seg_probs",
                                                      [None] * 3)]
    top = np.zeros((mb_w, 4), int)
    mbs = []
    for _ in range(mb_h):
        left = [0] * 4
        for x in range(mb_w):
            if h["update_map"]:
                if not d.bit(seg_probs[0]):
                    d.bit(seg_probs[1])
                else:
                    d.bit(seg_probs[2])
            skip = d.bit(skip_p) if use_skip else 0
            i4x4 = not d.bit(145)
            if not i4x4:
                ymode = (1 if d.bit(128) else 3) if d.bit(156) else (
                    2 if d.bit(163) else 0)
                top[x] = ymode
                left = [ymode] * 4
            else:
                for y in range(4):
                    ymode = left[y]
                    for k in range(4):
                        prob = t["bmodes"][top[x][k]][ymode]
                        i = _YMODES_INTRA4[d.bit(int(prob[0]))]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + d.bit(int(prob[i]))]
                        ymode = -i
                        top[x][k] = ymode
                    left[y] = ymode
            if d.bit(142) and d.bit(114):
                d.bit(183)
            mbs.append((i4x4, skip))
    return probs, mbs


def _coeffs(d: _BoolDecoder, p_type, ctx: int, n: int) -> int:
    p = p_type[_BANDS[n]][ctx]
    while n < 16:
        if not d.bit(int(p[0])):
            return n
        while not d.bit(int(p[1])):
            n += 1
            p = p_type[_BANDS[n]][0]
            if n == 16:
                return 16
        nxt = p_type[_BANDS[n + 1]]
        if not d.bit(int(p[2])):
            p = nxt[1]
        else:
            if not d.bit(int(p[3])):
                if d.bit(int(p[4])):
                    d.bit(int(p[5]))
            elif not d.bit(int(p[6])):
                if not d.bit(int(p[7])):
                    d.bit(159)
                else:
                    d.bit(165)
                    d.bit(145)
            else:
                bit1 = d.bit(int(p[8]))
                bit0 = d.bit(int(p[9 + bit1]))
                for prob in _CAT[2 * bit1 + bit0]:
                    d.bit(prob)
            p = nxt[2]
        d.bit(128)  # the sign
        n += 1
    return 16


def _parse_tokens(d: _BoolDecoder, probs, mbs, mb_w: int, mb_h: int):
    """Each macroblock's token symbols, as (probability, bit) lists."""
    top = [[0] * 9 for _ in range(mb_w)]  # 4 Y, 2 U, 2 V, Y2
    out = []
    for _ in range(mb_h):
        left = [0] * 9
        for x in range(mb_w):
            i4x4, skip = mbs[len(out)]
            start = len(d.ops)
            if skip:
                top[x][:8] = left[:8] = [0] * 8
                if not i4x4:
                    top[x][8] = left[8] = 0
            else:
                first = 0
                if not i4x4:
                    nz = _coeffs(d, probs[1], top[x][8] + left[8], 0)
                    top[x][8] = left[8] = int(nz > 0)
                    first = 1
                ptype = probs[0] if not i4x4 else probs[3]
                for y in range(4):
                    for k in range(4):
                        nz = _coeffs(d, ptype, top[x][k] + left[y], first)
                        top[x][k] = left[y] = int(nz > first)
                for c in (4, 6):
                    for y in range(2):
                        for k in range(2):
                            nz = _coeffs(d, probs[2],
                                         top[x][c + k] + left[c + y], 0)
                            top[x][c + k] = left[c + y] = int(nz > 0)
            out.append(d.ops[start:])
    return out


def _transcode(data: bytes, **changes) -> bytes:
    """A simple lossy file with its VP8 header fields changed: `simple`,
    `level`, `sharpness`, `deltas` (ref, mode: four each), `absolute`
    (segment values as deltas from the base) and `parts` (1, 2, 4 or 8
    token partitions, macroblock row y in partition y mod parts)."""
    assert data[12:16] == b"VP8 "
    vp8 = data[20:20 + struct.unpack_from("<I", data, 16)[0]]
    w = (vp8[6] | vp8[7] << 8) & 0x3FFF
    h = (vp8[8] | vp8[9] << 8) & 0x3FFF
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    part_len = (vp8[0] | vp8[1] << 8 | vp8[2] << 16) >> 5
    d = _BoolDecoder(vp8[10:10 + part_len])
    hdr = _parse_header(d)
    assert hdr["log2_parts"] == 0
    n_head = len(d.ops)
    probs, mbs = _parse_modes(d, hdr, mb_w, mb_h)
    tail = d.ops[n_head:]
    tokens = _parse_tokens(_BoolDecoder(vp8[10 + part_len:]), probs, mbs,
                           mb_w, mb_h)
    if "simple" in changes:
        hdr["simple"] = changes["simple"]
    if "level" in changes:
        hdr["level"] = changes["level"]
    if "sharpness" in changes:
        hdr["sharpness"] = changes["sharpness"]
    if "deltas" in changes:
        ref, mode = changes["deltas"]
        hdr.update(use_lf_delta=1, lf_update=1, ref_delta=list(ref),
                   mode_delta=list(mode))
    if changes.get("absolute") == 0 and hdr["update_data"]:
        base = hdr["base_q"]
        hdr["absolute"] = 0
        hdr["quant"] = [(v or 0) - base for v in hdr["quant"]]
        hdr["fstrength"] = [(v or 0) - hdr["level"]
                            for v in hdr["fstrength"]]
    parts = changes.get("parts", 1)
    hdr["log2_parts"] = parts.bit_length() - 1
    e = _BoolEncoder()
    _write_header(e, hdr)
    for prob, b in tail:
        e.bit(prob, b)
    first = e.finish()
    encoders = [_BoolEncoder() for _ in range(parts)]
    for i, ops in enumerate(tokens):
        for prob, b in ops:
            encoders[(i // mb_w) % parts].bit(prob, b)
    blobs = [enc.finish() for enc in encoders]
    sizes = b"".join(len(b).to_bytes(3, "little") for b in blobs[:-1])
    tag = (len(first) << 5) | (vp8[0] & 0x1F)  # key frame, profile, shown
    body = (tag.to_bytes(3, "little") + vp8[3:10] + first + sizes
            + b"".join(blobs))
    return riff(chunk(b"VP8 ", body))


@pytest.fixture(scope="module")
def coded(strip):
    """A lossy file with segments and 4x4 and 16x16 macroblocks."""
    return webp(strip[:75, 1200:1321], quality=60, method=4)


def test_transcoder_reproduces_the_file(coded):
    """With nothing changed the transcoded file decodes as the original
    (Pillow), so the symbols were read with the right probabilities."""
    vp8 = coded[20:]
    part_len = (vp8[0] | vp8[1] << 8 | vp8[2] << 16) >> 5
    d = _BoolDecoder(vp8[10:10 + part_len])
    hdr = _parse_header(d)
    assert hdr["update_map"] and hdr["update_data"] and hdr["level"]
    mbs = _parse_modes(d, hdr, 8, 5)[1]
    assert {i4x4 for i4x4, _ in mbs} == {False, True}
    np.testing.assert_array_equal(pillow(_transcode(coded)), pillow(coded))
    np.testing.assert_array_equal(pillow(_transcode(coded, parts=4)),
                                  pillow(coded))


@pytest.mark.parametrize("changes", [
    {"simple": 1},
    {"simple": 1, "level": 40},
    {"simple": 1, "level": 63, "sharpness": 3},
    {"level": 0},
    {"level": 63},
    *({"sharpness": s, "level": 30} for s in range(1, 8)),
    {"deltas": ((5, -3, 0, 0), (-8, 0, 0, 0))},
    {"deltas": ((-63, 0, 0, 0), (63, 0, 0, 0)), "simple": 1},
    {"deltas": ((20, 0, 0, 0), (10, 0, 0, 0)), "level": 50},
    {"absolute": 0},
    {"parts": 2},
    {"parts": 4, "simple": 1},
    {"parts": 8, "deltas": ((1, 0, 0, 0), (-1, 0, 0, 0))},
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_header_fields_pillows_encoder_never_sets(coded, changes):
    data = _transcode(coded, **changes)
    assert_bit_equal(data)
    vp8 = data[20:]
    part_len = (vp8[0] | vp8[1] << 8 | vp8[2] << 16) >> 5
    hdr = _parse_header(_BoolDecoder(vp8[10:10 + part_len]))
    for key, field in (("simple", "simple"), ("level", "level"),
                       ("sharpness", "sharpness"), ("absolute", "absolute")):
        if key in changes:
            assert hdr[field] == changes[key]
    assert 1 << hdr["log2_parts"] == changes.get("parts", 1)
    if "deltas" in changes:
        assert (tuple(hdr["ref_delta"]), tuple(hdr["mode_delta"])) == \
            changes["deltas"]


def test_token_partition_cut_short_is_refused(coded):
    """libwebp refuses a frame whose token data ends before its last
    macroblock ("Premature end-of-file"); the port does not read zeros
    past the end."""
    data = _transcode(coded, parts=2)
    cut = riff(chunk(b"VP8 ", data[20:-40]))
    with pytest.raises(Exception):
        pillow(cut)
    with pytest.raises(BadRequest):
        decode_upload(cut)


# ------------------------------------------------------------ robustness


def _variants(data: bytes, seed: int):
    yield from (data[:len(data) * k // 64] for k in range(64))
    rng = np.random.default_rng(seed)
    for _ in range(200):
        v = bytearray(data)
        v[int(rng.integers(len(v)))] = int(rng.integers(256))
        yield bytes(v)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "noise"])
def test_truncations_and_byte_flips_refused_where_pillow_refuses(strip,
                                                                  kind):
    """Each truncation and flip decodes as Pillow decodes it or is refused
    where Pillow refuses it. Flipped noise (the last kind) drives the
    inverse DCT past 16 bits, where libwebp's x86 transform wraps."""
    img = strip[100:140, 200:263]
    if kind == "lossy":
        data = webp(img, quality=70)
    elif kind == "lossless":
        data = webp(img, lossless=True)
    elif kind == "alpha":
        alpha = np.random.default_rng(3).integers(0, 256, img.shape[:2],
                                                  dtype=np.uint8)
        data = webp(np.dstack([img, alpha]), quality=70, alpha_quality=60)
    else:
        noise = np.random.default_rng(4).integers(0, 256, (23, 31, 4),
                                                  dtype=np.uint8)
        data = webp(noise, quality=40, alpha_quality=50)
    refused = 0
    for v in _variants(data, seed=len(kind)):
        try:
            want = pillow(v)
        except Exception:
            want = None
        if want is None:
            refused += 1
            with pytest.raises(BadRequest):
                decode_upload(v)
        else:
            got = decode_upload(v)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert 64 <= refused < 264


# ------------------------------------------------ the committed fixtures


def make_webp_fixtures() -> dict:
    """The WebP fixtures `chip_smoke.py` decodes on the card, built from
    the committed JPEGs (decoded by the port) with Pillow's encoder:
    name -> bytes. Regenerate them (and `pillow_rgb_sha256.json`) with
    this function if the JPEG fixtures change."""
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        strip = decode_upload(f.read())
    with open(os.path.join(FIXTURES, "scene_exif6.jpg"), "rb") as f:
        scene = decode_image(f.read())
    ex = Image.Exif()
    ex[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(strip[:, :1250]).save(
        buf, format="WEBP", save_all=True, duration=100, quality=70,
        append_images=[Image.fromarray(strip[:, 1250:])])
    return {
        "strip_q80.webp": webp(strip, quality=80),
        "scene_exif6.webp": webp(scene[::2, ::2], quality=70,
                                 exif=ex.tobytes()),
        "strip_lossless_crop.webp": webp(strip[:, 600:1400], lossless=True),
        "strip_anim2.webp": buf.getvalue(),
    }


def test_committed_webp_fixtures():
    """The committed files are what `make_webp_fixtures` builds (a lossy
    strip, a VP8X scene with EXIF orientation 6, a lossless crop, a
    2-frame animation), under 400 KB together, and decode bit-equal to
    Pillow."""
    made = make_webp_fixtures()
    total = 0
    for name, data in made.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            committed = f.read()
        assert committed == data, name
        total += len(committed)
        assert_bit_equal(committed)
    assert total < 400_000
    assert made["strip_q80.webp"][12:16] == b"VP8 "
    assert b"EXIF" in made["scene_exif6.webp"]
    assert decode_image(made["scene_exif6.webp"]).shape == (1450, 320, 3)
    assert decode_upload(made["scene_exif6.webp"]).shape == (320, 1450, 3)
    assert made["strip_lossless_crop.webp"][12:16] == b"VP8L"
    assert made["strip_anim2.webp"].count(b"ANMF") == 2
