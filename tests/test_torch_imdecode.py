"""The port's upload decoder (`ecgmm_torch.serve.imdecode`) against Pillow,
which the JAX HTTP handler decodes uploads with
(`np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`,
`ecgmm_tpu/serve/http.py:101-112`). Pillow is used here only, as the
reference; the bar is bit equality.

The committed fixtures under `ecgmm_torch/serve/fixtures/` were made with
Pillow: `strip.jpg` is `ecgmm_tpu.data.synthetic.make_cohort(n=1,
signal_len=2476, img_hw=(250, 2500)).images[0]` saved as JPEG with
Pillow's defaults (the JAX serve hammer's body); `scene_exif6.jpg` is that
strip on a 640x2900 table-coloured photo, stored rotated a quarter turn
counter-clockwise with EXIF orientation 6, at quality 90;
`pillow_rgb_sha256.json` holds the SHA-256 of Pillow's RGB decode of
each."""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, ImageOps

from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_torch import native
from ecgmm_torch.serve import imdecode
from ecgmm_torch.serve.imdecode import decode_image, decode_upload
from ecgmm_torch.serve.wire import BadRequest

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ecgmm_torch", "serve", "fixtures")


def pillow(data: bytes) -> np.ndarray:
    return np.asarray(
        ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


def assert_bit_equal(data: bytes):
    got = decode_upload(data)
    want = pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def photo():
    """A strip photo (the synthetic cohort's first strip, 250x2500) with
    sensor-like noise added, so the chroma carries detail."""
    strip = jax_synthetic.make_cohort(n=1, signal_len=2476,
                                      img_hw=(250, 2500), seed=4).images[0]
    noise = np.random.default_rng(0).integers(-12, 13, strip.shape)
    return np.clip(strip.astype(np.int64) + noise, 0, 255).astype(np.uint8)


def _jpeg(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "gray"])
@pytest.mark.parametrize("hw", [(101, 157), (250, 2500), (9, 3)])
def test_jpeg_bit_equal_to_pillow(photo, hw, subsampling, quality):
    img = photo[:hw[0], :hw[1]]
    if subsampling == "gray":
        data = _jpeg(img[:, :, 1], quality=quality)
    else:
        data = _jpeg(img, quality=quality, subsampling=subsampling)
    assert_bit_equal(data)


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 7},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_jpeg_restart_intervals(photo, restart, subsampling):
    assert_bit_equal(_jpeg(photo[:77, :301], subsampling=subsampling,
                           **restart))


@pytest.mark.parametrize("kwargs", [
    {}, {"subsampling": "4:4:4"}, {"subsampling": "4:2:2", "quality": 95},
    {"restart_marker_blocks": 3}, {"gray": True}],
    ids=["420", "444", "422-q95", "restart", "gray"])
@pytest.mark.parametrize("hw", [(101, 157), (250, 2500), (9, 3)])
def test_progressive_jpeg_bit_equal_to_pillow(photo, hw, kwargs):
    """Progressive JPEG (SOF2), the form a browser's or an editor's "save
    for web" writes: DC first and refinement scans, spectral bands with
    end-of-band runs, successive-approximation refinement."""
    kwargs = dict(kwargs)
    img = photo[:hw[0], :hw[1]]
    if kwargs.pop("gray", False):
        img = img[:, :, 1]
    data = _jpeg(img, progressive=True, **kwargs)
    assert b"\xff\xc2" in data
    assert_bit_equal(data)


def _without_huffman_tables(data: bytes) -> bytes:
    segments, rest = _segments(data)
    out = b"\xff\xd8"
    for marker, body in segments:
        if marker != 0xC4:
            out += bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) \
                + body
    return out + rest


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "gray"])
def test_jpeg_without_huffman_tables(photo, subsampling):
    """A JPEG with no DHT marker (as Motion-JPEG frames are stored) decodes
    with the Annex K tables, which libjpeg-turbo fills in; Pillow's own
    JPEGs use those tables, so dropping its DHT markers keeps the image."""
    img = photo[:60, :130]
    if subsampling == "gray":
        data = _jpeg(img[:, :, 0])
    else:
        data = _jpeg(img, subsampling=subsampling)
    bare = _without_huffman_tables(data)
    assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    assert_bit_equal(bare)
    np.testing.assert_array_equal(decode_upload(bare), decode_upload(data))


def test_jpeg_adobe_rgb(photo):
    """keep_rgb: an Adobe APP14 marker with transform 0 and no JFIF
    marker, which libjpeg reads as RGB without conversion."""
    data = _jpeg(photo[:50, :333], keep_rgb=True)
    assert b"Adobe" in data and b"JFIF" not in data
    assert_bit_equal(data)


def _with_orientation(img, orientation, fmt):
    im = Image.fromarray(img)
    exif = im.getexif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    im.save(buf, format=fmt, exif=exif.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations(photo, orientation, fmt):
    data = _with_orientation(photo[:40, :90], orientation, fmt)
    assert_bit_equal(data)
    if orientation in (5, 6, 7, 8):
        assert decode_upload(data).shape[:2] == (90, 40)


def test_xmp_orientation_when_exif_has_none(photo):
    """Without an EXIF orientation tag Pillow reads XMP's
    tiff:Orientation; an EXIF tag, where present, wins."""
    xmp = (b'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF><rdf:Description '
           b'tiff:Orientation="6"/></rdf:RDF></x:xmpmeta>')
    plain = _jpeg(photo[:30, :70], xmp=xmp)
    assert_bit_equal(plain)
    assert decode_upload(plain).shape[:2] == (70, 30)
    im = Image.fromarray(photo[:30, :70])
    exif = im.getexif()
    exif[0x0112] = 3
    buf = io.BytesIO()
    im.save(buf, format="JPEG", xmp=xmp, exif=exif.tobytes())
    assert_bit_equal(buf.getvalue())
    assert decode_upload(buf.getvalue()).shape[:2] == (30, 70)


# ---------------------------------------------------------------- PNG


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_row(ft, row, prev, bpp):
    row = row.astype(np.int64)
    prev = prev.astype(np.int64)
    out = np.empty_like(row)
    for x in range(len(row)):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        if ft == 0:
            p = 0
        elif ft == 1:
            p = a
        elif ft == 2:
            p = b
        elif ft == 3:
            p = (a + b) // 2
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (row[x] - p) % 256
    return out.astype(np.uint8).tobytes()


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _packed_rows(sub, depth):
    """Samples (h, w, ch) as PNG row bytes: big-endian 16-bit, or packed
    1, 2 or 4 bits to a byte, the leftmost first."""
    flat = sub.reshape(sub.shape[0], -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(sub.shape[0], -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(sub.shape[0], -1),
                       axis=1)


def write_png(pixels, color_type, interlace, palette=None, extra=b"",
              depth=8):
    """A PNG whose rows cycle through the five filter types (per pass,
    Adam7 when interlaced)."""
    h, w, ch = pixels.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    k = 0
    for x0, y0, dx, dy in passes:
        sub = pixels[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _packed_rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            ft = k % 5
            k += 1
            raw += bytes([ft]) + _filter_row(ft, row, prev, bpp)
            prev = row
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    return (out + extra + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_from_pillow(photo, mode):
    buf = io.BytesIO()
    Image.fromarray(photo[:61, :203]).convert(mode).save(buf, format="PNG")
    assert_bit_equal(buf.getvalue())


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color_type", [0, 2, 3, 4, 6])
@pytest.mark.parametrize("hw", [(23, 37), (1, 5), (9, 1)])
def test_png_filters_and_interlace(hw, color_type, interlace):
    """Every colour type, each row filter, Adam7 (with empty passes at the
    small sizes); a palette of 7 entries whose index 9 reads black."""
    rng = np.random.default_rng(color_type + 10 * interlace)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    pixels = rng.integers(0, 256, size=hw + (ch,), dtype=np.uint8)
    palette = None
    if color_type == 3:
        pixels = rng.integers(0, 10, size=hw + (1,), dtype=np.uint8)
        palette = rng.integers(0, 256, size=21, dtype=np.uint8).tobytes()
    assert_bit_equal(write_png(pixels, color_type, interlace, palette))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color_type,depth", [
    (0, 1), (0, 2), (0, 4), (0, 16), (3, 1), (3, 2), (3, 4), (2, 16),
    (4, 16), (6, 16)])
def test_png_bit_depths(color_type, depth, interlace):
    """PNG of bit depth 1, 2, 4 and 16 as Pillow converts it: gray scaled
    to 0-255 below 8 bits and clipped at 255 at 16, palette indices past
    the palette black, 16-bit colour and gray+alpha by the high byte."""
    rng = np.random.default_rng(10 * color_type + depth + 100 * interlace)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    palette = None
    for hw in [(23, 37), (1, 5), (9, 1)]:
        pixels = rng.integers(0, 1 << depth, size=hw + (ch,))
        if color_type == 3:
            n = min(1 << depth, 10)
            palette = rng.integers(0, 256, size=3 * n,
                                   dtype=np.uint8).tobytes()
        if depth == 16 and color_type == 0:
            # most samples above 255 (clipped), some below
            pixels = np.where(rng.random(pixels.shape) < 0.3,
                              pixels % 256, pixels)
        assert_bit_equal(write_png(pixels, color_type, interlace, palette,
                                   depth=depth))


def test_png_raw_profile_exif(photo):
    """ImageMagick's "Raw profile type exif" text chunk carries the
    orientation where there is no eXIf chunk."""
    im = Image.fromarray(photo[:20, :50])
    exif = im.getexif()
    exif[0x0112] = 8
    blob = b"Exif\x00\x00" + exif.tobytes()
    text = "\nexif\n%8d\n%s\n" % (len(blob), blob.hex())
    extra = _chunk(b"tEXt", b"Raw profile type exif\x00" + text.encode())
    data = write_png(photo[:20, :50], 2, 0, extra=extra)
    assert_bit_equal(data)
    assert decode_upload(data).shape[:2] == (50, 20)


# ----------------------------------------------------- what it refuses


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    i = data.index(marker)
    b = bytearray(data)
    b[i + offset] = value
    return bytes(b)


def _first_scans(data: bytes, n: int) -> bytes:
    """A progressive JPEG cut after its first n scans, ended with EOI."""
    pos = 0
    for _ in range(n + 1):
        pos = data.index(b"\xff\xda", pos + 2)
    return data[:pos] + b"\xff\xd9"


def test_unsupported_and_undecodable_raise_bad_request(photo):
    """Progressive JPEG, 16-bit PNG and CMYK JPEG, once refused here,
    decode now (test_progressive_jpeg_bit_equal_to_pillow,
    test_png_bit_depths, test_cmyk_jpeg_bit_equal_to_pillow); so do a
    progressive JPEG whose scans stop before its first coefficients are
    whole (libjpeg's block smoothing) and a Huffman stream under an
    arithmetic frame header (SOF9), once refused too: bit-equal to Pillow
    (more in test_torch_jpeg_arith_lossless.py). The same stream under
    SOF3 is refused by both (its scan header is no lossless one), and so
    are 12-bit, hierarchical and DNL-height JPEG."""
    img = photo[:40, :90]
    partial = _first_scans(_jpeg(img, progressive=True), 2)
    relabelled = _patched(_jpeg(img), b"\xff\xc0", 1, 0xC9)
    for data in (partial, relabelled):
        assert_bit_equal(data)
        np.testing.assert_array_equal(
            decode_image(data), np.asarray(Image.open(io.BytesIO(
                data)).convert("RGB")))
    lossless = _patched(_jpeg(img), b"\xff\xc0", 1, 0xC3)
    with pytest.raises(Exception):
        pillow(lossless)
    cases = [
        (lossless, "bad lossless scan parameters"),
        (_patched(_jpeg(img), b"\xff\xc0", 4, 12), "12-bit JPEG"),
        (b"not an image", "not a decodable image"),
        (_jpeg(img)[:300], "not a decodable image"),
        (b"GIF89a" + b"\x00" * 20, "GIF with no image"),
        (b"RIFF\x24\x00\x00\x00WEBPVP8 " + b"\x00" * 24,
         "truncated WebP file"),
        (b"RIFF\x20\x00\x00\x00WEBPVP8 " + b"\x00" * 24,
         "chunk too short"),
        (b"RIFF\x04\x00\x00\x00WEBPALPH",
         "no image plugin identifies it"),
    ]
    three = bytearray(write_png(img[:, :, :1], 0, 0))
    ihdr = three.index(b"IHDR")
    three[ihdr + 12] = 3  # a bit depth PNG does not define
    three[ihdr + 17:ihdr + 21] = struct.pack(
        ">I", zlib.crc32(bytes(three[ihdr:ihdr + 17])) & 0xFFFFFFFF)
    cases.append((bytes(three), "bad PNG header"))
    hierarchical = _patched(_jpeg(img), b"\xff\xc0", 1, 0xC5)
    dnl = _patched(_patched(_jpeg(img), b"\xff\xc0", 5, 0),
                   b"\xff\xc0", 6, 0)
    cases += [(hierarchical, "hierarchical JPEG"), (dnl, "DNL marker")]
    for data, want in cases:
        with pytest.raises(BadRequest, match=want):
            decode_upload(data)
    for data, want in cases[1:2] + cases[-2:]:
        assert "ROADMAP" in _message(data)


def _cmyk_jpeg(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def _adobe_transform(data: bytes, transform) -> bytes:
    """The JPEG with its Adobe APP14 transform flag set to `transform`, or
    the marker's name spoiled (None) so that decoders see no Adobe
    marker."""
    i = data.index(b"Adobe")
    out = bytearray(data)
    if transform is None:
        out[i] = ord("X")
    else:
        out[i + 11] = transform
    return bytes(out)


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_jpeg_bit_equal_to_pillow(photo, progressive, quality):
    """Pillow writes CMYK JPEG inverted, with an Adobe marker of transform
    0; it reads it back inverted ("CMYK;I") and converts with nk = 255 - K
    (`Convert.c` cmyk2rgb). The port follows both, bit for bit."""
    data = _cmyk_jpeg(photo[:120, :300], quality=quality,
                      progressive=progressive)
    assert data[data.index(b"Adobe") + 11] == 0
    assert_bit_equal(data)


@pytest.mark.parametrize("transform", [2, 1])
@pytest.mark.parametrize("progressive", [False, True])
def test_ycck_jpeg_bit_equal_to_pillow(photo, progressive, transform):
    """Adobe transform 2 (and any other but 0) makes libjpeg read the four
    components as YCCK: the first three through its YCbCr->RGB arithmetic,
    inverted, K as stored (`ycck_cmyk_convert`). Pillow cannot write YCCK,
    so a CMYK file's transform flag is set to 2 (or 1) here; libjpeg
    decodes the same scans as YCCK then."""
    data = _adobe_transform(_cmyk_jpeg(photo[:120, :300],
                                       progressive=progressive), transform)
    assert Image.open(io.BytesIO(data)).mode == "CMYK"
    assert_bit_equal(data)


def test_four_component_jpeg_without_adobe_marker_is_cmyk(photo):
    """Without an Adobe marker libjpeg takes four components as CMYK."""
    assert_bit_equal(_adobe_transform(_cmyk_jpeg(photo[:64, :96]), None))


def _message(data):
    try:
        decode_upload(data)
    except BadRequest as e:
        return str(e)
    raise AssertionError("decoded")


def _segments(data: bytes):
    """(marker, body) of each marker segment before the first scan, and
    the bytes from the scan's marker on."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length
    return out, data[pos:]


def _with_huffman_table(data: bytes, tc: int, n1: int) -> bytes:
    """The JPEG with its Huffman table of class tc (0: DC, 1: AC), id 0,
    replaced by one holding n1 codes of length 1 (their symbols in
    range): over-subscribed for n1 >= 2, since the code space of length 1
    holds the code 0 alone once the all-ones code is reserved."""
    segments, rest = _segments(data)
    out = b"\xff\xd8"
    for marker, body in segments:
        if marker == 0xC4:
            tables, i = b"", 0
            while i < len(body):
                total = sum(body[i + 1:i + 17])
                table = body[i:i + 17 + total]
                if body[i] == tc << 4:
                    symbols = bytes(k % 12 for k in range(n1))
                    table = bytes([tc << 4, n1]) + bytes(15) + symbols
                tables += table
                i += 17 + total
            body = tables
        out += bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) \
            + body
    return out + rest


@pytest.mark.parametrize("n1", [3, 255])
@pytest.mark.parametrize("tc", [0, 1], ids=["dc", "ac"])
def test_oversubscribed_huffman_tables_are_refused(photo, tc, n1):
    """A Huffman table whose codes overrun their code space is refused
    with BadRequest, as libjpeg refuses it (Pillow fails to load it)."""
    data = _with_huffman_table(_jpeg(photo[:40, :90]), tc, n1)
    with pytest.raises(OSError):
        pillow(data)
    with pytest.raises(BadRequest, match="bad Huffman table"):
        decode_upload(data)


@pytest.mark.parametrize("n1", [2, 3, 255])
@pytest.mark.parametrize("table", [0, 7])
def test_native_scan_decoder_refuses_oversubscribed_tables(table, n1):
    """The native scan decoder checks each table's code space itself,
    before it fills its lookup table: an over-subscribed table in the
    last slot (AC 3) or the first (DC 0) returns the bad-table code
    without writing past the table."""
    lib = native.library()
    bits = np.zeros((8, 17), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    bits[:, 1] = 1  # one code of length 1: a valid table
    bits[table, 1] = n1
    comp = np.array([1, 1, table % 4, 3 if table else 0, 1], np.int32)
    coef = np.zeros(64, np.int16)
    offsets = np.zeros(1, np.int64)
    out = np.zeros(2, np.int64)
    buf = np.zeros(16, np.uint8)
    status = lib.ecgmm_jpeg_huffman_scan(
        buf.ctypes.data, len(buf), 0, 1, comp.ctypes.data, coef.ctypes.data,
        offsets.ctypes.data, 1, 1, 0, 0, 0, 63, 0, 0, bits.ctypes.data,
        vals.ctypes.data, 1, out.ctypes.data)
    assert status == -1


def _png_header(width: int, height: int) -> bytes:
    return b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, 8, 2, 0, 0, 0))


def test_decompression_bombs_are_refused(photo):
    """Pillow's guards hold before anything is allocated: a frame past
    MAX_PIXELS (a 65535x65535 JPEG, a 2^31-1 x 2^31-1 PNG), and a PNG
    whose image data inflates far past what its header needs (1 GiB of
    zeros behind an 8x8 header) decodes from the first 8 rows alone; a
    text chunk that inflates past 1 MiB is refused."""
    big_jpeg = bytearray(_jpeg(photo[:40, :90]))
    sof = big_jpeg.index(b"\xff\xc0")
    big_jpeg[sof + 5:sof + 9] = struct.pack(">HH", 65535, 65535)
    assert 65535 * 65535 > imdecode.MAX_PIXELS
    big_png = _png_header(2 ** 31 - 1, 2 ** 31 - 1) + _chunk(
        b"IDAT", zlib.compress(b"\x00" * 64)) + _chunk(b"IEND", b"")
    for data in (bytes(big_jpeg), big_png):
        with pytest.raises(BadRequest, match="decompression bomb"):
            decode_upload(data)
    # 8 rows of (filter byte + 24 bytes), then 1 GiB more of zeros
    inflater = zlib.compressobj(9)
    stream = inflater.compress(b"\x00" * (8 * 25))
    chunk = b"\x00" * (1 << 20)
    for _ in range(1024):
        stream += inflater.compress(chunk)
    stream += inflater.flush()
    assert len(stream) < 2 * 1024 * 1024
    bomb = _png_header(8, 8) + _chunk(b"IDAT", stream) + _chunk(b"IEND",
                                                               b"")
    np.testing.assert_array_equal(decode_upload(bomb), pillow(bomb))
    text = _chunk(b"zTXt", b"Comment\x00\x00" + zlib.compress(
        b" " * (imdecode.MAX_TEXT_CHUNK + 1)))
    with_text = write_png(photo[:8, :8], 2, 0, extra=text)
    with pytest.raises(ValueError):
        pillow(with_text)
    with pytest.raises(BadRequest, match="text chunk inflates past"):
        decode_upload(with_text)


def test_committed_fixtures_decode_to_pillows_hashes():
    """The hashes chip_smoke.py holds the card machine's decode to are
    Pillow's decode of the committed files, here."""
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    assert set(hashes) == {"strip.jpg", "scene_exif6.jpg", "strip_q80.webp",
                           "scene_exif6.webp", "strip_lossless_crop.webp",
                           "strip_anim2.webp", "strip_arith.jpg",
                           "strip_arith_prog.jpg", "strip_lossless_crop.jpg",
                           "strip_smoothed.jpg", "strip_arith_whole.jpg",
                           "strip_ycbcr22.tif", "strip_g4.tif",
                           "crop_lzw_tiled.tif", "crop.ppm",
                           "strip_lzma.tif", "strip_zstd.tif",
                           "strip_rlew.tif", "strip_thunder.tif",
                           "strip_ojpeg.tif", "strip.tga", "crop_rgb.tga",
                           "strip.qoi", "strip.psd", "strip_rle8.dib",
                           "square.ico", "square.cur", "strip_layers.jp2",
                           "strip_97.jp2",
                           "crop_pcrl_tiled.j2k", "crop_97_styles.j2k",
                           "crop_la.jp2"}
    for name, want in hashes.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        if want.get("refused"):  # an upload both refuse
            with pytest.raises(Exception):
                pillow(data)
            with pytest.raises(BadRequest):
                decode_upload(data)
            continue
        for rgb in (pillow(data), decode_upload(data)):
            assert list(rgb.shape) == want["shape"]
            assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
                want["rgb_sha256"]


def test_strip_fixture_is_the_cohort_strip():
    """strip.jpg is the JAX hammer's body: the cohort's first strip
    through JPEG (quality 75), within JPEG's error."""
    strip = jax_synthetic.make_cohort(n=1, signal_len=2476,
                                      img_hw=(250, 2500)).images[0]
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        got = decode_upload(f.read())
    assert got.shape == strip.shape
    err = np.abs(got.astype(np.int64) - strip.astype(np.int64))
    assert err.mean() < 3.0


def _bmp(rows, bpp, width, palette=None, top_down=False, core=False,
         colors=None):
    """A BMP file by hand: `rows` (height, bytes) of packed pixels top row
    first, padded here to 4 bytes; a BITMAPCOREHEADER (3-byte palette
    entries) with `core`, else a BITMAPINFOHEADER (4-byte entries)."""
    height = len(rows)
    stride = (width * bpp + 31) // 32 * 4
    body = b"".join(bytes(r) + b"\x00" * (stride - len(r))
                    for r in (rows if top_down else rows[::-1]))
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(c[::-1]) + (b"" if core else b"\x00")
                       for c in palette)
    if core:
        dib = struct.pack("<IHHHH", 12, width, height, 1, bpp)
    else:
        dib = struct.pack("<IiiHHIIiiII", 40, width,
                          -height if top_down else height, 1, bpp, 0,
                          len(body), 2835, 2835,
                          colors if colors is not None else 0, 0)
    offset = 14 + len(dib) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + dib + pal + body)


def _packed(index, bpp):
    """Rows of palette indices packed `bpp` bits a pixel, high bits
    first."""
    if bpp == 8:
        return [bytes(r) for r in index]
    per = 8 // bpp
    out = []
    for r in index:
        r = list(r) + [0] * (-len(r) % per)
        out.append(bytes(sum(v << (8 - bpp * (j + 1))
                             for j, v in enumerate(r[i:i + per]))
                         for i in range(0, len(r), per)))
    return out


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("core", [False, True])
@pytest.mark.parametrize("bpp", [1, 4, 8, 24, 32])
def test_bmp_bit_equal_to_pillow(bpp, core, top_down):
    """Uncompressed BMP at every bit depth the decoder reads, bottom-up
    and top-down (a BITMAPCOREHEADER has no sign: bottom-up only), built
    by hand and held bit for bit against Pillow's `.convert("RGB")`; a
    palette index beyond the file's colours is black in both."""
    if core and top_down:
        top_down = False
    rng = np.random.default_rng(bpp)
    width, height = 13, 6
    if bpp >= 24:
        rgb = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        k = bpp // 8
        px = np.zeros((height, width, k), np.uint8)
        px[..., :3] = rgb[..., ::-1]
        if k == 4:
            px[..., 3] = rng.integers(0, 256, (height, width))
        data = _bmp([r.tobytes() for r in px.reshape(height, -1)], bpp,
                    width, top_down=top_down, core=core)
    else:
        # a core header has no count: its palette holds 2 ** bpp colours
        n = 1 << bpp if core else min(1 << bpp, 12)
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        index = rng.integers(0, min(1 << bpp, n + 2), (height, width))
        data = _bmp(_packed(index, bpp), bpp, width, palette=palette,
                    top_down=top_down, core=core,
                    colors=None if core else n)
    np.testing.assert_array_equal(decode_upload(data), pillow(data))
    with Image.open(io.BytesIO(data)) as im:
        assert im.size == (width, height)


def test_bmp_saved_by_pillow_and_refusals(photo):
    """Pillow's own BMP files (RGB, RGBA, palette, gray, 1-bit) decode
    bit-equal; a run-length compression on a depth it does not apply to,
    a JPEG-compressed BMP, 16-bit bitfields that Pillow does not read and
    a header over the pixel limit are refused, the last before any pixel
    is read."""
    img = photo[:21, :37]
    for mode in ("RGB", "RGBA", "P", "L", "1"):
        im = Image.fromarray(img)
        im = im.convert(mode) if mode != "P" else im.convert(
            "P", palette=Image.ADAPTIVE, colors=16)
        buf = io.BytesIO()
        im.save(buf, format="BMP")
        np.testing.assert_array_equal(decode_upload(buf.getvalue()),
                                      pillow(buf.getvalue()))
    good = bytearray(_bmp([b"\x00" * 6] * 2, 24, 2))
    rle = bytearray(good)
    rle[30:34] = struct.pack("<I", 1)
    jpeg = bytearray(good)
    jpeg[30:34] = struct.pack("<I", 4)
    bomb = bytearray(good)
    bomb[18:26] = struct.pack("<ii", 100000, 100000)
    odd_masks = _bitfields_bmp(np.zeros((2, 2), np.uint16), 16,
                               (0xF000, 0x0F00, 0x00F0))
    for data, want in ((rle, "compression 1"), (jpeg, "compression 4"),
                       (odd_masks, "bitfields layout"),
                       (bomb, "decompression bomb"),
                       (bytes(good[:40]), "truncated")):
        with pytest.raises(BadRequest, match=want):
            decode_upload(bytes(data))


# ---------------------------------------------------------------- GIF, and
# the compressed and 16-bit BMP layouts


def _lzw(indices, min_code):
    """GIF LZW codes for `indices`, the simplest valid stream: a clear
    code before every run of literal codes short enough that the code
    size never grows, then the end code; returns the data sub-blocks."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    size = min_code + 1
    room = (1 << size) - (clear + 2)  # literals before the size would grow
    codes = []
    for i in range(0, len(indices), max(1, room)):
        codes.append(clear)
        codes += list(indices[i:i + max(1, room)])
    codes.append(end)
    acc = nbits = 0
    out = bytearray()
    for c in codes:
        acc |= c << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes([min_code]) + blocks + b"\x00"


def _gif(screen, frame_box, index, global_palette=None, local_palette=None,
         transparency=None, interlace=False, min_code=8, tail=b";"):
    """A GIF89a by hand: the logical screen (w, h), one frame at
    frame_box (x0, y0, w, h) of palette `index` rows (stored interlaced
    where asked), the colour tables as (n, 3) arrays (n a power of two),
    a graphic control extension with the transparency index."""
    def table(p):
        return (len(p).bit_length() - 2) | 0x80, bytes(np.asarray(
            p, np.uint8).reshape(-1))

    flags, gtab = (table(global_palette) if global_palette is not None
                   else (0, b""))
    out = b"GIF89a" + struct.pack("<HHBBB", *screen, flags, 0, 0) + gtab
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) \
            + b"\x00"
    out += b"!\xfe\x05hello\x00"  # a comment, skipped
    lflags, ltab = (table(local_palette) if local_palette is not None
                    else (0, b""))
    rows = np.asarray(index, np.uint8)
    if interlace:
        lflags |= 0x40
        rows = rows[np.concatenate([np.arange(a, len(rows), b) for a, b in
                                    ((0, 8), (4, 8), (2, 4), (1, 2))])]
    out += b"," + struct.pack("<HHHHB", *frame_box, lflags) + ltab
    return out + _lzw(rows.reshape(-1).tolist(), min_code) + tail


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("case", ["global", "local", "grey", "none",
                                  "transparent_inset", "short_table"])
def test_gif_bit_equal_to_pillow(case, interlace):
    """The first frame of hand-made GIFs against Pillow's
    `.convert("RGB")`: a global colour table, a local one over a global
    one, an identity grey table (Pillow's mode L), no table at all, a
    frame inset in a larger screen whose margin takes the transparency
    index, and indices past a short table; rows plain and interlaced."""
    rng = np.random.default_rng(len(case) + interlace)
    w, h = 23, 19
    pal = rng.integers(0, 256, (16, 3))
    kw = {}
    screen, box = (w, h), (0, 0, w, h)
    index = rng.integers(0, 16, (h, w))
    if case == "global":
        kw["global_palette"] = pal
    elif case == "local":
        kw["global_palette"] = rng.integers(0, 256, (4, 3))
        kw["local_palette"] = pal
    elif case == "grey":
        kw["global_palette"] = np.repeat(np.arange(16)[:, None], 3, 1)
    elif case == "transparent_inset":
        kw["global_palette"] = pal
        kw["transparency"] = 5
        screen, box = (w + 7, h + 4), (3, 2, w, h)
    elif case == "short_table":
        kw["global_palette"] = pal[:4]
        kw["min_code"] = 5
        index = rng.integers(0, 32, (h, w))
    data = _gif(screen, box, index, interlace=interlace, **kw)
    np.testing.assert_array_equal(decode_upload(data), pillow(data))


@pytest.mark.parametrize("mode", ["P", "L", "RGB"])
def test_gif_saved_by_pillow(photo, mode):
    """Pillow's own GIF files (its LZW coder grows the code size and
    fills the table) of a strip decode bit-equal."""
    im = Image.fromarray(photo[:120, :900])
    im = im.quantize(200) if mode == "P" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="GIF")
    assert_bit_equal(buf.getvalue())


def test_gif_refusals():
    """A GIF whose image data stops early, one with a code beyond the
    table, one with no image and one over the pixel limit are refused,
    as Pillow refuses them."""
    pal = np.zeros((4, 3))
    good = _gif((5, 4), (0, 0, 5, 4), np.ones((4, 5)), global_palette=pal,
                min_code=2)
    cut = good[:-6]
    bad_code = bytearray(good)
    lzw_at = good.index(b",") + 10
    bad_code[lzw_at + 2] = 0xFF  # a code far past the table
    bomb = bytearray(good)
    bomb[6:10] = struct.pack("<HH", 65535, 65535)
    cases = ((cut, "truncated GIF"), (bytes(bad_code), "LZW code"),
             (good[:good.index(b",")] + b";", "GIF with no image"),
             (bytes(bomb), "decompression bomb"))
    for data, want in cases:
        if want != "decompression bomb":
            with pytest.raises(Exception):
                pillow(data)
        with pytest.raises(BadRequest, match=want):
            decode_upload(data)


def _bitfields_bmp(pixels, bpp, masks, hsize=40):
    """A BI_BITFIELDS BMP of `pixels` (height, width) uint16 or uint32,
    top row first, with the masks after a 40-byte header or inside a
    larger one."""
    height, width = pixels.shape
    dtype = "<u2" if bpp == 16 else "<u4"
    stride = (width * bpp + 31) // 32 * 4
    body = b"".join(r.astype(dtype).tobytes().ljust(stride, b"\x00")
                    for r in pixels[::-1])
    masks = tuple(masks) + (0,) * (4 - len(masks))
    dib = struct.pack("<IiiHHIIiiII", hsize, width, height, 1, bpp, 3,
                      len(body), 0, 0, 0, 0)
    if hsize == 40:
        extra = struct.pack("<III", *masks[:3])
    else:
        dib += struct.pack("<IIII", *masks)
        dib = dib[:hsize].ljust(hsize, b"\x00")
        extra = b""
    offset = 14 + len(dib) + len(extra)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + dib + extra + body)


@pytest.mark.parametrize("hsize", [40, 56, 124])
@pytest.mark.parametrize("layout", [
    (16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)),
    (32, (0xFF0000, 0xFF00, 0xFF)), (32, (0xFF000000, 0xFF0000, 0xFF00)),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)), (32, (0, 0, 0, 0))])
def test_bmp_bitfields_bit_equal_to_pillow(layout, hsize):
    """BI_BITFIELDS at 16 bits (5-6-5, 5-5-5) and 32 bits with the masks
    Pillow reads, the masks after a 40-byte header or inside a V3/V5
    header. A 40-byte header carries no alpha mask: where that leaves a
    layout Pillow does not read, both refuse it."""
    bpp, masks = layout
    if hsize == 40 and len(masks) == 4 and masks[3]:
        masks = masks[:3]
    rng = np.random.default_rng(bpp + hsize)
    px = rng.integers(0, 1 << bpp, (7, 11), dtype=np.uint64)
    data = _bitfields_bmp(px, bpp, masks, hsize)
    try:
        want = pillow(data)
    except OSError:
        with pytest.raises(BadRequest, match="bitfields layout"):
            decode_upload(data)
        return
    np.testing.assert_array_equal(decode_upload(data), want)


def test_bmp_16_bit_rgb_bit_equal_to_pillow():
    """16-bit BI_RGB (5-5-5, the high bit unused), odd width, bottom-up
    and top-down."""
    rng = np.random.default_rng(16)
    px = rng.integers(0, 1 << 16, (5, 9), dtype=np.uint16)
    for top_down in (False, True):
        data = _bmp([r.astype("<u2").tobytes() for r in px], 16, 9,
                    top_down=top_down)
        np.testing.assert_array_equal(decode_upload(data), pillow(data))


def _rle_stream(rng, width, height, rle4, base, n_ops=160):
    """A random RLE8/RLE4 stream that starts at file offset `base`:
    encoded runs (some longer than the row has room for), absolute runs
    (odd lengths included, each padded to an even file offset), ends of
    line, deltas and, last, the end of the bitmap."""
    out = bytearray()
    top = 16 if rle4 else 256
    for _ in range(n_ops):
        op = rng.integers(0, 10)
        if op < 4:
            run = int(rng.integers(1, width + 4))
            out += bytes([run, int(rng.integers(0, 256))])
        elif op < 7:
            n = int(rng.integers(3, width + 2))
            vals = rng.integers(0, top, n)
            if rle4:
                vals = list(vals) + [0] * (n % 2)
                raw = bytes((vals[i] << 4) | vals[i + 1]
                            for i in range(0, len(vals), 2))
            else:
                raw = bytes(int(v) for v in vals)
            out += bytes([0, n]) + raw
            if (base + len(out)) % 2:
                out += b"\x00"
        elif op < 9:
            out += b"\x00\x00"
        else:
            out += b"\x00\x02\x00\x00" + bytes([int(rng.integers(0, 4)),
                                                int(rng.integers(0, 2))])
    return bytes(out) + b"\x00\x01"


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
def test_bmp_rle_bit_equal_to_pillow(rle4, seed, top_down):
    """RLE8 and RLE4 BMP against Pillow's decoder, quirks and all: runs
    clipped at the row's end, a row overrun by an absolute run running
    into the next row, padding to an even file offset, a delta that
    reads its (right, up) two bytes late, rows the stream never reaches
    left at index 0, and a palette index past the file's colours. A
    stream that ends before the last pixel is refused by both."""
    rng = np.random.default_rng(seed)
    width, height = 17, 9
    bpp = 4 if rle4 else 8
    n = 12
    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    pal = b"".join(bytes(c[::-1]) + b"\x00" for c in palette)
    dib_size, pad = 40, seed % 2  # an odd offset, too
    offset = 14 + dib_size + len(pal) + pad
    body = _rle_stream(rng, width, height, rle4, offset)
    dib = struct.pack("<IiiHHIIiiII", dib_size, width,
                      -height if top_down else height, 1, bpp,
                      2 if rle4 else 1, len(body), 0, 0, n, 0)
    data = (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + dib + pal + b"\x00" * pad + body)
    np.testing.assert_array_equal(decode_upload(data), pillow(data))
    short = data[:-len(body)] + body[:2] + b"\x00\x01"  # one run, the end
    with pytest.raises(ValueError, match="not enough image data"):
        pillow(short)
    with pytest.raises(BadRequest, match="ends before the last pixel"):
        decode_upload(short)


# Valid JPEG files of the kinds the port refuses, written here (Pillow
# writes none of them): lossless (SOF3), 12-bit (SOF1) and arithmetic-
# coded (SOF9).
_ANNEX_K_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _BitWriter:
    """Huffman-coded scan data: bits MSB first, 0xFF stuffed with 0x00,
    the last byte padded with ones."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> None:
        self.bits += [(value >> i) & 1 for i in range(n - 1, -1, -1)]

    def finish(self) -> bytes:
        bits = self.bits + [1] * (-len(self.bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            out.append(int("".join(map(str, bits[i:i + 8])), 2))
            if out[-1] == 0xFF:
                out.append(0)
        return bytes(out)


def _lossless_jpeg(gray: np.ndarray) -> bytes:
    """SOF3, one component, predictor 1 (the left sample; the first row's
    first sample predicted by 128, each row's first by the sample above),
    the differences coded with the Annex K DC table."""
    h, w = gray.shape
    codes, code, k = {}, 0, 0
    for length, count in enumerate(_ANNEX_K_DC_BITS, 1):
        for _ in range(count):
            codes[k] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    x = gray.astype(int).tolist()
    out = _BitWriter()
    for r in range(h):
        for c in range(w):
            pred = (128 if r == c == 0 else x[r - 1][c] if c == 0
                    else x[r][c - 1])
            d = x[r][c] - pred
            size = abs(d).bit_length()
            out.put(*codes[size])
            out.put(d if d >= 0 else d - 1 + (1 << size), size)
    return (b"\xff\xd8"
            + _segment(0xC4, bytes([0x00, *_ANNEX_K_DC_BITS, *range(12)]))
            + _segment(0xC3, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00")
            + _segment(0xDA, b"\x01\x01\x00\x01\x00\x00")  # Ss 1: predictor 1
            + out.finish() + b"\xff\xd9")


def _twelve_bit_jpeg() -> bytes:
    """SOF1 at 12-bit precision: one flat 8x8 block (DC difference 0,
    then end of block; an AC table whose one code "0" is EOB)."""
    out = _BitWriter()
    out.put(0b00, 2)  # DC size 0 (Annex K)
    out.put(0b0, 1)   # EOB
    tables = (bytes([0x00, *_ANNEX_K_DC_BITS, *range(12)])
              + bytes([0x10, 1] + [0] * 15 + [0x00]))
    return (b"\xff\xd8" + _segment(0xDB, b"\x00" + bytes([1] * 64))
            + _segment(0xC4, tables)
            + _segment(0xC1, struct.pack(">BHHB", 12, 8, 8, 1) + b"\x01\x11\x00")
            + _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00")
            + out.finish() + b"\xff\xd9")


def _arithmetic_jpeg() -> bytes:
    """SOF9: one flat 8x8 block, its DC difference 1 (quantised by 16),
    then end of block. The four decisions (T.81 F.1.4: the difference is
    not zero, its sign, its magnitude category, end of block at k = 1)
    each use a context of their own, so each is coded in the QM coder's
    first state (Qe 0x5A1D, MPS 0): T.81 Annex D's encoder (libjpeg's
    `jcarith.c`) for that state, without the carry and 0xFF handling
    these decisions never need (asserted), zero bytes written at once."""
    qe = 0x5A1D
    a, c, ct, buffer, out = 0x10000, 0, 11, -1, bytearray()

    def emit_byte(temp):  # D.1.6's byte out, with no carry or 0xFF run
        nonlocal buffer
        assert temp < 0xFF
        if buffer >= 0:
            out.append(buffer)
        buffer = temp

    for decision in (1, 0, 0, 1):  # 1 is the LPS
        a -= qe
        if decision and a >= qe or not decision and a < 0x8000 and a < qe:
            c, a = c + a, qe  # the conditional exchange
        if not decision and a >= 0x8000:
            continue
        while True:  # renormalise
            a, c, ct = a << 1, c << 1, ct - 1
            if ct == 0:
                emit_byte(c >> 19)
                c, ct = c & 0x7FFFF, ct + 8
            if a >= 0x8000:
                break
    temp = (a - 1 + c) & 0xFFFF0000  # D.1.8: the most trailing zeros
    c = temp + 0x8000 if temp < c else temp
    c <<= ct
    assert not c & 0xF8000000
    if buffer >= 0:
        out.append(buffer)
    if c & 0x7FFF800:
        out.append((c >> 19) & 0xFF)
        if c & 0x7F800:
            out.append((c >> 11) & 0xFF)
    assert 0xFF not in out
    return (b"\xff\xd8" + _segment(0xDB, b"\x00" + bytes([16] * 64))
            + _segment(0xC9, struct.pack(">BHHB", 8, 8, 8, 1) + b"\x01\x11\x00")
            + _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00")
            + bytes(out) + b"\xff\xd9")


def test_valid_lossless_12bit_and_arithmetic_jpeg():
    """Pillow 12.1 (libjpeg-turbo) decodes a lossless and an
    arithmetic-coded JPEG, and so does the port now, bit-equal (it
    refused both before); Pillow refuses a 12-bit one at open ("cannot
    handle 12-bit layers") and a hierarchical one at load, as the port
    does."""
    rng = np.random.default_rng(0)
    img = np.clip(np.add.outer(np.arange(8) * 9, np.arange(12) * 7)
                  + rng.integers(0, 20, (8, 12)), 0, 255).astype(np.uint8)
    lossless = _lossless_jpeg(img)
    np.testing.assert_array_equal(pillow(lossless),
                                  np.repeat(img[:, :, None], 3, axis=2))
    assert_bit_equal(lossless)
    arithmetic = _arithmetic_jpeg()
    np.testing.assert_array_equal(pillow(arithmetic), 130)
    assert_bit_equal(arithmetic)
    twelve = _twelve_bit_jpeg()
    with pytest.raises(Exception):
        pillow(twelve)
    with pytest.raises(BadRequest, match="12-bit JPEG"):
        decode_upload(twelve)
    # libjpeg-turbo refuses a hierarchical frame (SOF5-SOF7) on its marker
    # alone, whatever follows it; so does the port
    for marker in (0xC5, 0xC6, 0xC7):
        hierarchical = _patched(_jpeg(img[:, :, None].repeat(3, axis=2)),
                                b"\xff\xc0", 1, marker)
        with pytest.raises(Exception):
            pillow(hierarchical)
        with pytest.raises(BadRequest, match="hierarchical JPEG"):
            decode_upload(hierarchical)
