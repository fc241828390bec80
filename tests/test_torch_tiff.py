"""The port's TIFF reader (`ecgmm_torch.serve.tiff`, through
`imdecode.decode_upload` and `decode_image`) against Pillow, which the JAX
handler decodes uploads with
(`np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`).
Pillow is the reference here only; the bar is bit equality, and a refusal
where Pillow refuses.

Files come from Pillow's TIFF writer (libtiff under it) where it can make
them. Tiled files, planar configuration 2 beside compression, YCbCr
JPEG-in-TIFF at 2x1 and 2x2 and old-style LZW it cannot, so they are put
together here: a directory written first, then strips or tiles, each one
coded by Pillow (a one-row image of the chunk's bytes for the byte-wise
codecs, a JPEG of the tile for JPEG) or, for old-style LZW, by the encoder
below."""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, ImageOps

from ecgmm_torch.serve.imdecode import decode_image, decode_upload
from ecgmm_torch.serve.wire import BadRequest

_FORMATS = {1: "B", 3: "H", 4: "L", 5: "LL", 6: "b", 8: "h", 9: "l",
            10: "ll", 11: "f", 12: "d", 16: "Q"}
CODECS = {"raw": 1, "tiff_ccitt": 2, "group3": 3, "group4": 4,
          "tiff_lzw": 5, "jpeg": 7, "tiff_adobe_deflate": 8,
          "packbits": 32773, "tiff_deflate": 32946}
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ecgmm_torch", "serve", "fixtures")
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


def pillow(data: bytes) -> np.ndarray:
    return np.asarray(
        ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


def assert_same(data: bytes) -> str:
    """Both decode to the same array (returns "decoded"), or both refuse
    ("refused")."""
    try:
        want = pillow(data)
    except Exception:
        want = None
    if want is None:
        with pytest.raises(BadRequest):
            decode_upload(data)
        return "refused"
    got = decode_upload(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    stored = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_image(data), stored)
    return "decoded"


def build(tags, chunks, endian="<", tiled=False) -> bytes:
    """A TIFF whose first directory comes right after the header, its
    out-of-line values next, then the chunks (strips or tiles), their
    offsets and byte counts filled in. tags: {tag: (type, values)} with
    values a list (bytes for types 1 and 7 where given as bytes, str for
    2)."""
    tags = dict(tags)
    off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
    tags.setdefault(cnt_tag, (4, [len(c) for c in chunks]))
    tags[off_tag] = (4, [0] * len(chunks))

    def encode(typ, vals):
        if isinstance(vals, (bytes, bytearray)):
            return bytes(vals), len(vals)
        if typ == 2:
            b = vals.encode("latin-1") + b"\0"
            return b, len(b)
        out = b"".join(struct.pack(endian + _FORMATS[typ],
                                   *(v if isinstance(v, tuple) else (v,)))
                       for v in vals)
        return out, len(vals)

    def layout():
        pos = 8 + 2 + 12 * len(tags) + 4
        for tag in sorted(tags):
            b, _ = encode(*tags[tag])
            if len(b) > 4:
                pos += len(b) + (len(b) & 1)
        offsets = []
        for c in chunks:
            offsets.append(pos)
            pos += len(c)
        return offsets

    tags[off_tag] = (4, layout())
    out = bytearray((b"II*\0" if endian == "<" else b"MM\0*")
                    + struct.pack(endian + "L", 8))
    out += struct.pack(endian + "H", len(tags))
    extra = bytearray()
    extra_at = 8 + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        typ, vals = tags[tag]
        b, count = encode(typ, vals)
        out += struct.pack(endian + "HHL", tag, typ, count)
        if len(b) > 4:
            out += struct.pack(endian + "L", extra_at + len(extra))
            extra += b + b"\0" * (len(b) & 1)
        else:
            out += b.ljust(4, b"\0")
    out += struct.pack(endian + "L", 0) + extra
    for c in chunks:
        out += c
    return bytes(out)


def build_big(tags, chunks) -> bytes:
    """A little-endian BigTIFF of LONG8 strip offsets and counts, its
    directory first (8-byte counts and offsets, values of up to 8 bytes
    inline)."""
    tags = dict(tags)
    tags[279] = (16, [len(c) for c in chunks])
    tags[273] = (16, [0] * len(chunks))

    def encode(typ, vals):
        if isinstance(vals, (bytes, bytearray)):
            return bytes(vals), len(vals)
        out = b"".join(struct.pack("<" + _FORMATS[typ],
                                   *(v if isinstance(v, tuple) else (v,)))
                       for v in vals)
        return out, len(vals)

    head = 16 + 8 + 20 * len(tags) + 8
    extra = sum(len(encode(*tags[t])[0]) for t in tags
                if len(encode(*tags[t])[0]) > 8)
    pos = head + extra
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    tags[273] = (16, offsets)
    out = bytearray(b"II+\0" + struct.pack("<HHQ", 8, 0, 16))
    out += struct.pack("<Q", len(tags))
    blob = bytearray()
    for tag in sorted(tags):
        b, count = encode(*tags[tag])
        out += struct.pack("<HHQ", tag, tags[tag][0], count)
        if len(b) > 8:
            out += struct.pack("<Q", head + len(blob))
            blob += b
        else:
            out += b.ljust(8, b"\0")
    out += struct.pack("<Q", 0) + blob
    for c in chunks:
        out += c
    return bytes(out)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits",
                                         "tiff_adobe_deflate"])
def test_bigtiff(photo, compression):
    """BigTIFF (II+): 8-byte counts and offsets, read by Pillow and by
    libtiff."""
    img = photo[:20, :31]
    chunks = [coded(img[y:y + 8].tobytes(), compression)
              for y in range(0, 20, 8)]
    tags = _base_tags(31, 20, 8, 2, 3, CODECS[compression], {278: (3, [8])})
    data = build_big(tags, chunks)
    assert assert_same(data) == "decoded"
    np.testing.assert_array_equal(decode_upload(data), img)


def save(im: Image.Image, **kwargs) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kwargs)
    return buf.getvalue()


def strips_of(data: bytes):
    """The strip bytes of a Pillow-written TIFF."""
    im = Image.open(io.BytesIO(data))
    return [data[o:o + n] for o, n in zip(im.tag_v2[273], im.tag_v2[279])]


def coded(raw: bytes, compression: str) -> bytes:
    """`raw` coded by Pillow's writer (libtiff) with a byte-wise codec: the
    one strip of a one-row 8-bit image of those bytes."""
    if compression == "raw":
        return raw
    im = Image.frombytes("L", (len(raw), 1), raw)
    (strip,) = strips_of(save(im, compression=compression))
    return strip


def jpeg_of(img: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def split_tables(jpeg: bytes):
    """(JPEGTables: SOI, DQT and DHT segments, EOI; the image without
    them), as libtiff's writer splits a JPEG stream."""
    tables, rest = [], [b"\xff\xd8"]
    pos = 2
    while True:
        marker = jpeg[pos + 1]
        length = struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        seg = jpeg[pos:pos + 2 + length]
        if marker == 0xDA:
            rest.append(jpeg[pos:])
            break
        (tables if marker in (0xC4, 0xDB) else rest).append(seg)
        pos += 2 + length
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", b"".join(rest)


@pytest.fixture(scope="module")
def photo():
    """A 45x70 RGB image: smooth gradients, edges and noise."""
    rng = np.random.default_rng(17)
    y, x = np.mgrid[:45, :70]
    img = np.stack([x * 3, y * 5, (x + y) * 2], axis=2) % 256
    img = img + rng.integers(-20, 21, img.shape)
    img[10:20, 5:40] = (250, 10, 30)
    return np.clip(img, 0, 255).astype(np.uint8)


def _mode_image(photo, mode):
    im = Image.fromarray(photo)
    if mode == "P":
        return im.quantize(40)
    if mode == "I;16":
        return Image.fromarray(photo[..., 0].astype(np.uint16) * 3 + 100)
    if mode == "I;16B":
        return Image.fromarray(photo[..., 0].astype(np.uint16) * 3 + 100
                               ).convert("I").convert("I;16B")
    if mode == "I":
        return Image.fromarray(photo[..., 0].astype(np.int32) * 2 - 90)
    if mode == "F":
        return Image.fromarray(photo[..., 1].astype(np.float32) * 1.3 - 9.5)
    return im.convert(mode)


WRITER_MODES = ["1", "L", "P", "RGB", "RGBA", "CMYK", "LA", "I;16",
                "I;16B", "I", "F"]


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", WRITER_MODES)
def test_pillow_written_tiffs_bit_equal(photo, compression, mode):
    """Every byte-wise codec against every mode Pillow writes, in strips
    of 8 rows (the last one short)."""
    data = save(_mode_image(photo, mode), compression=compression,
                rowsperstrip=8)
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK", "YCbCr"])
@pytest.mark.parametrize("quality", [40, 95])
def test_jpeg_in_tiff_written_by_pillow(photo, mode, quality):
    """Compression 7 as Pillow's writer makes it: JPEGTables and a JPEG
    stream a strip; RGB, grey and CMYK passed through as coded, YCbCr at
    1x1 converted by libjpeg."""
    im = Image.fromarray(photo).convert(mode)
    data = save(im, compression="jpeg", quality=quality, rowsperstrip=16)
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("compression,t4", [
    ("tiff_ccitt", None), ("group4", None), ("group3", None), ("group3", 1),
    ("group3", 4), ("group3", 5)])
@pytest.mark.parametrize("fill", [1, 2])
def test_ccitt_bilevel(photo, compression, t4, fill):
    """Modified Huffman RLE, Group 3 1-D and 2-D (T4Options bit 0), with
    EOLs byte-aligned (bit 2) and in either bit order, and Group 4, as
    Pillow writes them (one strip)."""
    im = Image.fromarray(photo).convert("L").point(
        lambda v: 255 if v > 110 else 0).convert("1")
    info = {266: fill}
    if t4 is not None:
        info[292] = t4
    data = save(im, compression=compression, tiffinfo=info)
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4"])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("fill", [1, 2])
def test_ccitt_strips_and_tiles(photo, compression, tiled, fill):
    """CCITT in strips of 8 rows and in 32x16 tiles (edge tiles cropped),
    each strip or tile coded by Pillow's writer, in either bit order."""
    bw = np.where(photo[..., 1] > 110, 255, 0).astype(np.uint8)
    h, w = bw.shape
    if tiled:
        blocks = [t[..., 0] for t in _tiles(bw[..., None], 32, 16)]
        more = {322: (3, [32]), 323: (3, [16])}
    else:
        blocks = [bw[y:y + 8] for y in range(0, h, 8)]
        more = {278: (3, [8])}
    chunks = []
    for block in blocks:
        (chunk,) = strips_of(save(Image.fromarray(block).convert("1"),
                                  compression=compression))
        if fill == 2:
            chunk = _REVERSE[np.frombuffer(chunk, np.uint8)].tobytes()
        chunks.append(chunk)
    more[266] = (3, [fill])
    data = build(_base_tags(w, h, 1, 0, 1, CODECS[compression], more),
                 chunks, tiled=tiled)
    assert assert_same(data) == "decoded"


def test_group4_strip_that_ends_early(photo, tmp_path):
    """A Group 4 strip whose data runs out: libtiff keeps the rows it
    decoded and leaves the rest of its buffer as it was, which the port
    gives as white; a strip that ends before its first row is refused."""
    bw = np.where(photo[:24, :33, 1] > 110, 255, 0).astype(np.uint8)
    (strip,) = strips_of(save(Image.fromarray(bw).convert("1"),
                              compression="group4"))
    tags = _base_tags(33, 24, 1, 0, 1, 4, {278: (3, [24])})
    data = build(tags, [strip[:len(strip) // 2]])
    unwritten = libtiff_unwritten_rows(data, tmp_path / "half.tif")
    assert 0 < len(unwritten) < 24
    got, want = decode_upload(data), pillow(data)
    written = sorted(set(range(24)) - unwritten)
    np.testing.assert_array_equal(got[written], want[written])
    assert np.all(got[sorted(unwritten)] == 255)
    # an EOL before the first row is done: no row decoded
    assert assert_same(build(tags, [b"\x00"])) == "refused"


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16", "CMYK"])
def test_predictor_2(photo, compression, mode):
    """Horizontal differencing at 8 and 16 bits, as Pillow writes it."""
    data = save(_mode_image(photo, mode), compression=compression,
                tiffinfo={317: 2}, rowsperstrip=9)
    assert Image.open(io.BytesIO(data)).tag_v2[317] == 2
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("predictor", [1, 2, 3])
@pytest.mark.parametrize("kind", ["F", "I"])
@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
def test_thirty_two_bit_samples_and_predictors(photo, predictor, kind,
                                                compression):
    """32-bit floats and integers as Pillow writes them: horizontal
    differencing on the 32-bit samples, libtiff's floating-point predictor
    (bytes differenced, then each sample's bytes gathered from byte
    planes), converted to RGB as Pillow converts F and I."""
    if kind == "F":
        im = Image.fromarray(photo[..., 1].astype(np.float32) * 1.7 - 40.25)
    else:
        im = Image.fromarray(photo[..., 0].astype(np.int32) * 3 - 200)
    if predictor == 3 and kind == "I":
        predictor = 2  # libtiff refuses the float predictor for integers
    data = save(im, compression=compression, tiffinfo={317: predictor},
                rowsperstrip=10)
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits"])
def test_big_endian_thirty_two_bit(photo, compression):
    """Big-endian 32-bit samples: Pillow's raw decoder reads them in the
    file's order; libtiff hands Pillow host-order samples that Pillow
    still unpacks as big-endian."""
    img = (photo[:20, :31, 0].astype(">f4") * 2.5 - 7.5)
    chunks = [coded(img[y:y + 8].tobytes(), compression)
              for y in range(0, 20, 8)]
    tags = _base_tags(31, 20, 32, 1, 1, CODECS[compression],
                      {278: (3, [8]), 339: (3, [3])})
    assert assert_same(build(tags, chunks, endian=">")) == "decoded"


@pytest.mark.parametrize("bits,photometric", [(1, 0), (4, 1), (8, 1),
                                              (8, 3), (16, 1)])
def test_one_band_in_planar_configuration_2(photo, bits, photometric):
    """One sample a pixel under planar configuration 2 reads as planar 1
    under libtiff; Pillow's raw decoder reads the first character of the
    rawmode ("L;4" as "L", "I;16" as "I"), so some of those it refuses."""
    g = photo[:16, :20, 1]
    if bits == 16:
        raw = (g.astype(np.uint16) * 50).astype("<u2").tobytes()
    elif bits == 8:
        raw = g.tobytes()
    else:
        idx = g >> (8 - bits)
        raw = np.packbits(np.unpackbits(idx[..., None], axis=2)[
            ..., 8 - bits:].reshape(16, -1), axis=1).tobytes()
    more = {278: (3, [16]), 284: (3, [2])}
    if photometric == 3:
        more[320] = (3, list(range(0, 768 * 85, 85)))
    for compression in ("raw", "tiff_lzw"):
        data = build(_base_tags(20, 16, bits, photometric, 1,
                                CODECS[compression], more),
                     [coded(raw, compression)])
        result = assert_same(data)
        assert result == "decoded" or compression == "raw"


def _ycbcr_blocks(rng, width, rows, hs, vs) -> bytes:
    """Random YCbCr sampling blocks for `rows` rows: each block hs x vs
    luma samples then Cb and Cr, block rows of ceil(width / hs) blocks."""
    n = -(-rows // vs) * -(-width // hs)
    return rng.integers(0, 256, n * (hs * vs + 2), dtype=np.uint8).tobytes()


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (1, 2), (2, 2),
                                      (4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate",
                                         "packbits"])
def test_ycbcr_not_jpeg_coded(sampling, compression):
    """YCbCr that is not JPEG-coded: Pillow reads it through libtiff's
    TIFFRGBAImage, whose tables convert each sampling block, chroma
    replicated, a strip at a time; widths and heights that are no
    multiple of the block."""
    hs, vs = sampling
    rng = np.random.default_rng(hs * 10 + vs)
    width, height, rows = 37, 23, 8
    strips = [coded(_ycbcr_blocks(rng, width, min(rows, height - y), hs, vs),
                    compression) for y in range(0, height, rows)]
    tags = _base_tags(width, height, 8, 6, 3, CODECS[compression],
                      {278: (3, [rows]), 530: (3, list(sampling))})
    assert assert_same(build(tags, strips)) == "decoded"


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_ycbcr_not_jpeg_coded_in_tiles(sampling):
    """gtTileContig: 16x16 tiles of sampling blocks, edge tiles cropped."""
    hs, vs = sampling
    rng = np.random.default_rng(hs * 7 + vs)
    width, height = 37, 23
    tiles = [coded(_ycbcr_blocks(rng, 16, 16, hs, vs), "tiff_lzw")
             for _ in range(-(-width // 16) * -(-height // 16))]
    tags = _base_tags(width, height, 8, 6, 3, 5, {
        322: (3, [16]), 323: (3, [16]), 530: (3, list(sampling))})
    assert assert_same(build(tags, tiles, tiled=True)) == "decoded"


@pytest.mark.parametrize("compression", ["tiff_lzw", "jpeg"])
@pytest.mark.parametrize("tiled", [False, True])
def test_ycbcr_in_planes(compression, tiled):
    """YCbCr in planar configuration 2 (JPEG-coded too: a one-component
    JPEG a plane's strip): libtiff's RGBA reader takes the three planes
    at 1x1; at its default 2x2 it refuses them."""
    rng = np.random.default_rng(9)
    width, height = 40, 32
    planes = rng.integers(0, 256, (3, height, width), dtype=np.uint8)
    planes[:, :, :20] = 128
    chunks = []
    for plane in planes:
        blocks = list(_tiles(plane[..., None], 16, 16)) if tiled else \
            [plane[y:y + 16] for y in range(0, height, 16)]
        for b in blocks:
            b = np.ascontiguousarray(b[..., 0] if b.ndim == 3 else b)
            chunks.append(jpeg_of(b, quality=85) if compression == "jpeg"
                          else coded(b.tobytes(), compression))
    more = {284: (3, [2]), 530: (3, [1, 1])}
    if tiled:
        more.update({322: (3, [16]), 323: (3, [16])})
    else:
        more[278] = (3, [16])
    tags = _base_tags(width, height, 8, 6, 3, CODECS[compression], more)
    assert assert_same(build(tags, chunks, tiled=tiled)) == "decoded"
    del tags[530]
    assert assert_same(build(tags, chunks, tiled=tiled)) == "refused"


@pytest.mark.parametrize("orientation", range(1, 9))
def test_ycbcr_not_jpeg_coded_orientations(orientation):
    """libtiff's RGBA reader, as Pillow drives it, turns no row whatever
    the orientation; Pillow applies the tag to the whole image after."""
    rng = np.random.default_rng(orientation)
    strips = [coded(_ycbcr_blocks(rng, 30, 6, 2, 2), "tiff_lzw")
              for _ in range(3)]
    tags = _base_tags(30, 18, 8, 6, 3, 5, {278: (3, [6]),
                                           274: (3, [orientation]),
                                           530: (3, [2, 2])})
    assert assert_same(build(tags, strips)) == "decoded"


def test_ycbcr_reference_black_white_and_coefficients():
    """ReferenceBlackWhite and YCbCrCoefficients other than the defaults,
    in libtiff's float arithmetic; a strip that fails to decode is read as
    the zeros libtiff leaves, since Pillow does not stop on errors."""
    rng = np.random.default_rng(5)
    strips = [coded(_ycbcr_blocks(rng, 21, 8, 1, 1), "tiff_lzw")
              for _ in range(2)]
    tags = _base_tags(21, 16, 8, 6, 3, 5, {
        278: (3, [8]), 530: (3, [1, 1]),
        529: (5, [(2990, 10000), (5870, 10000), (1140, 10000)]),
        532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                  (240, 1)])})
    assert assert_same(build(tags, strips)) == "decoded"
    tags[529] = (5, [(2126, 10000), (7152, 10000), (722, 10000)])
    assert assert_same(build(tags, [strips[0], strips[1][:9]])) == "decoded"


def _diff(rows: np.ndarray) -> np.ndarray:
    """Horizontal differencing of (rows, width, samples) samples."""
    out = rows.copy()
    out[:, 1:] = rows[:, 1:] - rows[:, :-1]
    return out


def _base_tags(width, height, bits, photometric, spp, compression,
               more=None):
    tags = {256: (4, [width]), 257: (4, [height]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp])}
    tags.update(more or {})
    return tags


def _chunk_bytes(block: np.ndarray, compression: str, predictor: bool,
                 big: bool) -> bytes:
    if predictor:
        block = _diff(block)
    if block.dtype == np.uint16:
        block = block.astype(">u2" if big else "<u2")
    return coded(block.tobytes(), compression)


def _tiles(img: np.ndarray, tw: int, tl: int):
    """The tiles of (H, W, S) `img`, row by row, edge tiles padded."""
    h, w = img.shape[:2]
    for y in range(0, h, tl):
        for x in range(0, w, tw):
            tile = np.zeros((tl, tw) + img.shape[2:], img.dtype)
            part = img[y:y + tl, x:x + tw]
            tile[:part.shape[0], :part.shape[1]] = part
            yield tile


@pytest.mark.parametrize("compression,predictor", [
    ("raw", False), ("packbits", False), ("tiff_lzw", False),
    ("tiff_lzw", True), ("tiff_adobe_deflate", False),
    ("tiff_adobe_deflate", True)])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("tiled", [False, True])
def test_hand_built_layouts(photo, compression, planar, predictor, tiled):
    """Tiles of 16x16 (edge tiles cropped) and strips of 8 rows, planar
    configuration 1 and 2, with and without predictor 2 (LZW and Deflate
    only), in RGB."""
    img = photo[:37, :53]
    h, w = img.shape[:2]
    planes = [img] if planar == 1 else [img[..., i:i + 1] for i in range(3)]
    chunks = []
    for plane in planes:
        if tiled:
            blocks = _tiles(plane, 16, 16)
        else:
            blocks = (plane[y:y + 8] for y in range(0, h, 8))
        chunks += [_chunk_bytes(b, compression, predictor, False)
                   for b in blocks]
    more = {284: (3, [planar])}
    if predictor:
        more[317] = (3, [2])
    if tiled:
        more.update({322: (3, [16]), 323: (3, [16])})
    else:
        more[278] = (3, [8])
    data = build(_base_tags(w, h, 8, 2, 3, CODECS[compression], more),
                 chunks, tiled=tiled)
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate",
                                         "packbits", "raw"])
@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("layout", [("RGB", 3, ()), ("RGBA", 4, (2,)),
                                    ("RGBa", 4, (1,)), ("RGBX", 4, (0,)),
                                    ("CMYK", 4, ())])
def test_sixteen_bit_colour(photo, compression, big, layout):
    """16-bit RGB, RGBA (unassociated and associated alpha), RGBX and
    CMYK in both byte orders: Pillow keeps the high bytes, and
    unpremultiplies associated alpha."""
    name, spp, extra = layout
    rng = np.random.default_rng(3)
    img = rng.integers(0, 65536, (21, 30, spp)).astype(np.uint16)
    img[..., -1] = np.maximum(img[..., -1], 300)
    chunks = [_chunk_bytes(img[y:y + 8], compression, False, big)
              for y in range(0, 21, 8)]
    more = {278: (3, [8])}
    if extra:
        more[338] = (3, list(extra))
    photometric = 5 if name == "CMYK" else 2
    data = build(_base_tags(30, 21, 16, photometric, spp, CODECS[compression],
                            more), chunks, endian=">" if big else "<")
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("photometric", [0, 1, 3])
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits"])
@pytest.mark.parametrize("fill", [1, 2])
def test_low_bit_depths_palettes_and_fill_order(bits, photometric,
                                               compression, fill):
    """Grey of 1, 2, 4 and 8 bits (WhiteIsZero and BlackIsZero) and
    palettes of those depths, in either fill order: Pillow's unpackers
    scale 2- and 4-bit grey, the palette is the ColorMap's high bytes,
    an index past a short ColorMap is black."""
    rng = np.random.default_rng(bits * 10 + photometric)
    h, w = 19, 27
    index = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
    rows = np.packbits(np.unpackbits(index[..., None], axis=2)[..., 8 - bits:]
                       .reshape(h, w * bits), axis=1)
    raw = rows.tobytes()
    if fill == 2:
        raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    more = {278: (3, [h]), 266: (3, [fill])}
    if photometric == 3:
        n = max(1, (1 << bits) - 1)  # one entry short
        cmap = rng.integers(0, 65536, 3 * n).tolist()
        more[320] = (3, cmap)
    data = build(_base_tags(w, h, bits, photometric, 1, CODECS[compression],
                            more), [coded(raw, compression)])
    assert_same(data)


@pytest.mark.parametrize("name,cmap", [
    ("LONG values past 16 bits", (4, [v * 4099 % (1 << 20)
                                      for v in range(768)])),
    ("signed values", (8, [v * 131 % 65536 - 32768 for v in range(768)])),
    ("rationals", (5, [(v * 257, 3) for v in range(768)])),
    ("floats", (11, [v / 768 for v in range(768)])),
    ("300 entries", (3, [v * 71 % 65536 for v in range(900)]))])
def test_colormap_of_odd_types(photo, name, cmap):
    """Pillow's palette takes the low byte of value // 256, refuses
    floats and more than 256 entries."""
    tags = _base_tags(20, 16, 8, 3, 1, 1, {278: (3, [16]), 320: cmap})
    want = "refused" if name in ("floats", "300 entries") else "decoded"
    assert assert_same(build(tags, [photo[:16, :20, 0].tobytes()])) == want


def lzw_compat(raw: bytes) -> bytes:
    """Old-style TIFF LZW: codes least significant bit first, the code
    width growing when the table passes 2^n - 1, a clear code first and an
    end code last."""
    out_bits, acc, nbits = [], 0, 0
    width = 9
    table = {bytes([i]): i for i in range(256)}
    next_code = 258

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out_bits.append(acc & 255)
            acc >>= 8
            nbits -= 8

    put(256)
    w = b""
    for b in raw:
        wb = w + bytes([b])
        if wb in table:
            w = wb
            continue
        put(table[w])
        table[wb] = next_code
        next_code += 1
        if next_code > 1 << width and width < 12:
            width += 1
        if next_code >= 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            next_code, width = 258, 9
        w = bytes([b])
    if w:
        put(table[w])
    put(257)
    if nbits:
        out_bits.append(acc & 255)
    return bytes(out_bits)


def test_old_style_lzw(photo):
    """libtiff's old-style (bit-reversed) LZW, which its decoder tells
    from the first two bytes, in strips."""
    img = photo[:30, :41]
    chunks = [lzw_compat(img[y:y + 10].tobytes()) for y in range(0, 30, 10)]
    assert chunks[0][0] == 0 and chunks[0][1] & 1
    data = build(_base_tags(41, 30, 8, 2, 3, 5, {278: (3, [10])}), chunks)
    assert assert_same(data) == "decoded"
    cut = build(_base_tags(41, 30, 8, 2, 3, 5, {278: (3, [10])}),
                [c[:len(c) // 2] for c in chunks])
    assert assert_same(cut) == "refused"


def _ycbcr_jpeg_tiff(img, sampling, tables, tiled, rows=16, quality=80):
    """YCbCr JPEG-in-TIFF put together by hand: each strip (or 16x16
    tile) a JPEG from Pillow's encoder at `sampling` (h, v), its tables
    moved into JPEGTables when `tables`."""
    h, w = img.shape[:2]
    sub = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[sampling]
    blocks = list(_tiles(img, 16, 16)) if tiled else \
        [img[y:y + rows] for y in range(0, h, rows)]
    streams = [jpeg_of(np.ascontiguousarray(b), subsampling=sub,
                       quality=quality) for b in blocks]
    more = {530: (3, list(sampling)), 284: (3, [1])}
    if tables:
        table, _ = split_tables(streams[0])
        streams = [split_tables(s)[1] for s in streams]
        more[347] = (7, table)
    if tiled:
        more.update({322: (3, [16]), 323: (3, [16])})
    else:
        more[278] = (3, [rows])
    return build(_base_tags(w, h, 8, 6, 3, 7, more), streams, tiled=tiled)


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_ycbcr_jpeg_subsampled(photo, sampling, tables, tiled):
    """The JPEG-in-TIFF scanners write: YCbCr at 2x1 and 2x2 (Pillow's
    writer makes neither), in strips (the last one short) or tiles, with
    and without JPEGTables; upsampling stops at each strip's edge, as
    libtiff's per-strip decoding does."""
    data = _ycbcr_jpeg_tiff(photo, sampling, tables, tiled)
    assert assert_same(data) == "decoded"


def test_jpeg_strip_with_the_wrong_sampling_is_refused(photo):
    """libtiff checks each strip's sampling against YCbCrSubsampling."""
    data = _ycbcr_jpeg_tiff(photo, (2, 2), True, False)
    wrong = data.replace(struct.pack("<HHLHH", 530, 3, 2, 2, 2),
                         struct.pack("<HHLHH", 530, 3, 2, 2, 1))
    assert wrong != data
    assert assert_same(wrong) == "refused"


def test_multipage_decodes_its_first_page(photo):
    frames = [Image.fromarray(photo), Image.fromarray(photo[::2, ::3]),
              Image.fromarray(photo).convert("L")]
    for compression in ("raw", "tiff_lzw", "jpeg"):
        buf = io.BytesIO()
        frames[0].save(buf, "TIFF", save_all=True, append_images=frames[1:],
                       compression=compression)
        data = buf.getvalue()
        assert Image.open(io.BytesIO(data)).n_frames == 3
        assert assert_same(data) == "decoded"
        assert decode_upload(data).shape == photo.shape


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "jpeg",
                                         "group4"])
def test_orientations(photo, orientation, compression):
    """The IFD's orientation, applied once inside Pillow's load: the
    handler's own exif_transpose then finds nothing, and
    `Image.open(f).convert("RGB")` is already upright."""
    im = Image.fromarray(photo[:40, :60])
    if compression == "group4":
        im = im.convert("1")
    data = save(im, compression=compression, tiffinfo={274: orientation})
    assert assert_same(data) == "decoded"
    want_hw = (60, 40) if orientation >= 5 else (40, 60)
    assert decode_upload(data).shape[:2] == want_hw
    assert decode_image(data).shape[:2] == want_hw


@pytest.mark.parametrize("entry", [
    (3, [6, 3]), (4, [6]), (5, [(6, 1)]), (5, [(12, 2)]), (5, [(6, 0)]),
    (8, [8]), (9, [5]), (1, [6]), (2, "6"), (11, [6.0]), (12, [7.5]),
    (7, b"\x06"), (16, [3])])
def test_orientation_tag_of_odd_types(photo, entry):
    """Pillow's reading of the orientation tag: a SHORT of two values
    keeps the first, a LONG or signed integer is the number, a RATIONAL
    compares as its value (6/1 turns, n/0 does not), bytes and text do
    not turn the image."""
    img = photo[:20, :31]
    tags = _base_tags(31, 20, 8, 2, 3, 1, {278: (3, [20]), 274: entry})
    data = build(tags, [img.tobytes()])
    assert assert_same(data) == "decoded"


def test_a_value_past_the_block_ends_the_directory(photo):
    """Pillow's directory reader stops at the first entry whose values lie
    past the data ("Truncated File Read"): an orientation after it in a
    JPEG's EXIF block is not read (the port read past such an entry
    before it shared the TIFF reader's directory code)."""
    entries = [(0x010F, 2, 100, struct.pack("<L", 5000)),
               (0x0112, 3, 1, struct.pack("<HH", 6, 0))]
    block = b"II*\0" + struct.pack("<LH", 8, len(entries))
    for tag, typ, count, field in entries:
        block += struct.pack("<HHL", tag, typ, count) + field
    block += struct.pack("<L", 0)
    buf = io.BytesIO()
    Image.fromarray(photo[:20, :31]).save(buf, "JPEG",
                                          exif=b"Exif\0\0" + block)
    assert assert_same(buf.getvalue()) == "decoded"
    assert decode_upload(buf.getvalue()).shape == (20, 31, 3)


def test_xmp_orientation_when_the_ifd_has_none(photo):
    img = photo[:20, :31]
    xmp = b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'
    data = build(_base_tags(31, 20, 8, 2, 3, 1, {278: (3, [20]),
                                                   700: (1, xmp)}),
                 [img.tobytes()])
    assert assert_same(data) == "decoded"
    assert decode_upload(data).shape == (31, 20, 3)


def test_refusals_and_unported_compressions(photo):
    """What Pillow refuses is refused; LZMA and ZSTD, which Pillow decodes
    here, the port decodes too (the other compressions that were once
    unported are tested in test_torch_tiff_codecs.py)."""
    img = photo[:16, :20]
    ok = _base_tags(20, 16, 8, 2, 3, 1, {278: (3, [16])})
    cases = {
        "no width": {k: v for k, v in ok.items() if k != 256},
        "rational width": {**ok, 256: (5, [(20, 1)])},
        "unknown compression": {**ok, 259: (3, [7777])},
        "unknown mode": {**ok, 258: (3, [8, 8, 16])},
        "too many samples": {**ok, 277: (3, [9])},
        "organisation": {**ok, 258: (3, [8, 8])},
        "YCbCr raw, 4 bytes a pixel read": {**ok, 262: (3, [6])},
    }
    for name, tags in cases.items():
        assert_same(build(tags, [img.tobytes()]))
    for name, tags in cases.items():
        if name.startswith("YCbCr"):
            continue
        with pytest.raises(BadRequest):
            decode_upload(build(tags, [img.tobytes()]))
    truncated = build(ok, [img.tobytes()])[:-5]
    assert assert_same(truncated) == "refused"
    with pytest.raises(BadRequest, match="no image plugin identifies it"):
        decode_upload(b"II*")
    for compression in ("lzma", "zstd"):
        data = save(Image.fromarray(img), compression=compression)
        assert assert_same(data) == "decoded"


def _libtiff():
    """Pillow's own libtiff, loaded beside Pillow's C module (which pulls
    in the libraries it links)."""
    import ctypes
    import glob
    import os

    from PIL import features

    assert features.version("libtiff")
    libs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(Image.__file__))), "pillow.libs")
    (path,) = glob.glob(os.path.join(libs, "libtiff*.so*"))
    lib = ctypes.CDLL(path)
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for name in ("TIFFStripSize", "TIFFScanlineSize"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_int64
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_void_p, ctypes.c_int64]
    lib.TIFFNumberOfStrips.restype = ctypes.c_uint32
    lib.TIFFNumberOfStrips.argtypes = [ctypes.c_void_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    return lib


def libtiff_unwritten_rows(data: bytes, path) -> set:
    """The image rows that libtiff's strip reads leave as the buffer held
    them (a Group 4 strip that ends early, a JPEG strip shorter than its
    strip): each strip is read twice, into a buffer of zeros and one of
    ones, and a row that differs was not written. Pillow reads its strips
    into one buffer it never clears, so what those rows hold is the
    previous strip's rows or, in the first strip, uninitialised memory."""
    import ctypes

    lib = _libtiff()
    path.write_bytes(data)
    tif = lib.TIFFOpen(str(path).encode(), b"rC")
    assert tif
    unwritten = set()
    try:
        # TIFFTAG_JPEGCOLORMODE = JPEGCOLORMODE_RGB, as Pillow sets it
        lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(65538),
                         ctypes.c_int(1))
        size, row = lib.TIFFStripSize(tif), lib.TIFFScanlineSize(tif)
        width, bits, spp = (ctypes.c_uint32(), ctypes.c_uint16(),
                            ctypes.c_uint16(1))
        for tag, value in ((256, width), (258, bits), (277, spp)):
            lib.TIFFGetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                             ctypes.byref(value))
        used = width.value * bits.value * spp.value  # bits past are padding
        for strip in range(lib.TIFFNumberOfStrips(tif)):
            reads = []
            for fill in (0, 255):
                buf = np.full(size, fill, np.uint8)
                lib.TIFFReadEncodedStrip(tif, strip, buf.ctypes.data, size)
                reads.append(np.unpackbits(buf.reshape(-1, row),
                                           axis=1)[:, :used])
            differ = np.any(reads[0] != reads[1], axis=1)
            rows = size // row
            unwritten |= {strip * rows + i for i in np.flatnonzero(differ)}
    finally:
        lib.TIFFClose(tif)
    return unwritten


def assert_same_but_unwritten(data: bytes, path) -> str:
    """assert_same, but rows libtiff leaves unwritten (whose content in
    Pillow is not defined) are not compared."""
    try:
        want = pillow(data)
    except Exception:
        return assert_same(data)
    got = decode_upload(data)
    assert got.shape == want.shape
    if not np.array_equal(got, want):
        differ = set(np.flatnonzero(np.any(got != want, axis=(1, 2))))
        assert differ <= libtiff_unwritten_rows(data, path)
    return "decoded"


def _cut_and_flip_cases(data: bytes, seed: int, n: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield data[:int(rng.integers(8, len(data)))]
        flipped = bytearray(data)
        at = int(rng.integers(8, len(data)))
        flipped[at] ^= 1 << int(rng.integers(0, 8))
        yield bytes(flipped)


def _fuzz_files(photo):
    """One small file a codec, its directory first (so a cut keeps it)."""
    img = photo[:24, :33]
    bw = (img[..., 1] > 100).astype(np.uint8) * 255
    out = {}
    for compression in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        chunks = [_chunk_bytes(img[y:y + 8], compression, compression
                               != "raw" and compression != "packbits", False)
                  for y in range(0, 24, 8)]
        more = {278: (3, [8])}
        if compression in ("tiff_lzw", "tiff_adobe_deflate"):
            more[317] = (3, [2])
        out[compression] = build(_base_tags(33, 24, 8, 2, 3,
                                            CODECS[compression], more),
                                 chunks)
    for compression in ("tiff_ccitt", "group3", "group4"):
        strips = [strips_of(save(Image.fromarray(bw[y:y + 8]).convert("1"),
                                 compression=compression))[0]
                  for y in range(0, 24, 8)]
        out[compression] = build(_base_tags(33, 24, 1, 0, 1,
                                            CODECS[compression],
                                            {278: (3, [8])}), strips)
    out["jpeg"] = _ycbcr_jpeg_tiff(img, (2, 2), True, False)
    rng = np.random.default_rng(3)
    out["ycbcr_deflate"] = build(
        _base_tags(33, 24, 8, 6, 3, 8, {278: (3, [8]), 530: (3, [2, 2])}),
        [coded(_ycbcr_blocks(rng, 33, 8, 2, 2), "tiff_adobe_deflate")
         for _ in range(3)])
    return out


FUZZED = ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "tiff_ccitt",
          "group3", "group4", "jpeg", "ycbcr_deflate"]


@pytest.mark.parametrize("codec", FUZZED)
def test_cuts_and_byte_flips(photo, codec, tmp_path):
    """Seeded cuts and single-bit flips anywhere past the header of one
    file a codec: the port refuses what Pillow refuses and decodes the
    rest to Pillow's bytes (but for rows libtiff leaves unwritten, which
    hold whatever Pillow's buffer held)."""
    data = _fuzz_files(photo)[codec]
    assert assert_same(data) == "decoded"
    seed = sorted(CODECS).index(codec) if codec in CODECS else len(CODECS)
    for case in _cut_and_flip_cases(data, seed, 12):
        assert_same_but_unwritten(case, tmp_path / "case.tif")


@pytest.mark.parametrize("codec", ["raw", "tiff_lzw", "tiff_adobe_deflate",
                                   "packbits", "group4", "jpeg"])
def test_decompression_bombs(codec):
    """A directory claiming 40000 x 40000 pixels is refused before
    anything is allocated; a Deflate strip that would inflate to 64 MiB
    inflates only to its strip's size."""
    huge = _base_tags(40000, 40000, 8, 1, 1, CODECS[codec],
                      {278: (3, [40000])})
    data = build(huge, [b"\0" * 64])
    with pytest.raises(BadRequest, match="decompression bomb"):
        decode_upload(data)
    with pytest.raises(Exception):
        pillow(data)
    if codec == "tiff_adobe_deflate":
        bomb = zlib.compress(b"\0" * (64 << 20), 9)
        small = build(_base_tags(16, 16, 8, 1, 1, 8, {278: (3, [16])}),
                      [bomb])
        assert assert_same(small) == "decoded"


def _one_pixel(bits, photometric, spp, compression, chunk, more):
    """A 1x1 file of one strip or tile `chunk`, its layout in `more`."""
    return build(_base_tags(1, 1, bits, photometric, spp, compression, more),
                 [chunk], tiled=322 in more)


_G4 = bytes([0x26, 0xA0, 0x00, 0x10, 0x01])
_Z = zlib.compress(b"\x80" * 8)
_YC = {530: (3, [1, 1])}
_SIZE_CASES = {
    # _decodeTile: a tile side above INT_MAX (the Group 4 run arrays of
    # such a row would wrap), a tile buffer of INT_MAX or more
    "g4 tile width 2^32-1": ((1, 0, 1, 4, _G4, {322: (4, [2 ** 32 - 1]),
                                                323: (4, [1])}), "refused"),
    "g4 tile length 2^32-1": ((1, 0, 1, 4, _G4, {322: (4, [16]),
                                                 323: (4, [2 ** 32 - 1])}),
                              "refused"),
    "g4 tile width 2^31-16": ((1, 0, 1, 4, _G4, {322: (4, [2 ** 31 - 16]),
                                                 323: (4, [1])}), "refused"),
    "deflate L 65535^2 tiles": ((8, 1, 1, 8, _Z, {322: (4, [65535]),
                                                  323: (4, [65535])}),
                                "refused"),
    "deflate RGB 65535^2 tiles": ((8, 2, 3, 8, _Z, {322: (4, [65535]),
                                                    323: (4, [65535])}),
                                  "refused"),
    "deflate 65536x32768 tiles": ((8, 1, 1, 8, _Z, {322: (4, [65536]),
                                                    323: (4, [32768])}),
                                  "refused"),
    "deflate 16x16 tiles": ((8, 1, 1, 8, zlib.compress(b"\x80" * 256),
                             {322: (4, [16]), 323: (4, [16])}), "decoded"),
    "raw 65535^2 tiles": ((8, 1, 1, 1, b"\x80" * 64, {322: (4, [65535]),
                                                      323: (4, [65535])}),
                          "decoded"),
    # _decodeStrip: RowsPerStrip above INT_MAX (but 2^32-1, the image)
    "deflate rows 2^31-1": ((8, 1, 1, 8, _Z, {278: (4, [2 ** 31 - 1])}),
                            "decoded"),
    "deflate rows 2^31": ((8, 1, 1, 8, _Z, {278: (4, [2 ** 31])}),
                          "refused"),
    "deflate rows 2^32-2": ((8, 2, 3, 8, _Z, {278: (4, [2 ** 32 - 2])}),
                            "refused"),
    "raw rows 2^32-2": ((8, 1, 1, 1, b"\x80", {278: (4, [2 ** 32 - 2])}),
                        "decoded"),
    # _decodeAsRGBA: a block of RGBA rows of INT_MAX bytes or more
    "ycbcr rows 2^29-1": ((8, 6, 3, 5, b"\x80\x00",
                           {278: (4, [2 ** 29 - 1]), **_YC}), "decoded"),
    "ycbcr rows 2^29": ((8, 6, 3, 5, b"\x80\x00",
                         {278: (4, [2 ** 29]), **_YC}), "refused"),
    "ycbcr tile length 2^31-16": ((8, 6, 3, 5, b"\x80\x00",
                                   {322: (4, [16]),
                                    323: (4, [2 ** 31 - 16]), **_YC}),
                                  "refused"),
    "ycbcr tile width 2^31+16": ((8, 6, 3, 5, b"\x80\x00",
                                  {322: (4, [2 ** 31 + 16]), 323: (4, [1]),
                                   **_YC}), "refused"),
    # _TIFFReadEncodedTileAndAllocBuffer: a tile buffer above 100 MB whose
    # count is under a thousandth of it
    "ycbcr 5773^2 tile": ((8, 6, 3, 8, _Z, {322: (4, [5773]),
                                            323: (4, [5773]), **_YC}),
                          "decoded"),
    "ycbcr 5774^2 tile": ((8, 6, 3, 8, _Z, {322: (4, [5774]),
                                            323: (4, [5774]), **_YC}),
                          "refused"),
    "ycbcr 6000^2 tile, 107999 bytes": (
        (8, 6, 3, 8, _Z + bytes(107999 - len(_Z)),
         {322: (4, [6000]), 323: (4, [6000]), **_YC}), "refused"),
    "ycbcr 6000^2 tile, 108000 bytes": (
        (8, 6, 3, 8, _Z + bytes(108000 - len(_Z)),
         {322: (4, [6000]), 323: (4, [6000]), **_YC}), "decoded"),
}


@pytest.mark.parametrize("case", list(_SIZE_CASES))
def test_strip_and_tile_sizes_at_pillows_bounds(case):
    """A 1x1 image whose strip or tile is claimed huge: refused before
    anything is allocated where Pillow's TiffDecode.c or libtiff refuses
    it (each bound held at both sides), decoded where they decode it."""
    args, want = _SIZE_CASES[case]
    assert assert_same(_one_pixel(*args)) == want


@pytest.mark.parametrize("compression,rowpixels", [
    (4, 2 ** 32 - 1), (4, 2 ** 31), (4, 2 ** 30), (3, 2 ** 31 - 32),
    (2, 2 ** 31), (2, 0)])
def test_fax_rows_too_wide_for_the_run_arrays(compression, rowpixels):
    """`ecgmm_tiff_fax` refuses a row whose run arrays libtiff could not
    count in 32 bits (Fax3SetupState), or of more than INT_MAX pixels,
    before it allocates or writes anything."""
    from ecgmm_torch import native
    out = np.zeros(16, np.uint8)
    no_eol = np.zeros(1, np.int32)
    status = native.library().ecgmm_tiff_fax(
        _G4, len(_G4), compression, 0, 0, rowpixels, 1, 1, out.ctypes.data,
        no_eol.ctypes.data)
    assert status == -33
    assert not out.any()


def _inflate_whole(raw: bytes, size: int):
    """The reference: one inflate call over the whole stream, bounded by
    the strip; where it fails, the output of inflate fed a byte at a time
    up to the byte that fails (that byte's own output dropped)."""
    try:
        return zlib.decompressobj().decompress(raw, size), False
    except zlib.error:
        pass
    z = zlib.decompressobj()
    got = b""
    for i in range(len(raw)):
        if len(got) == size:
            break
        try:
            got += z.decompress(raw[i:i + 1], size - len(got))
        except zlib.error:
            break
    return got, True


def test_inflate_a_piece_at_a_time():
    """The Deflate reader feeds inflate 16 KiB at a time, each piece's
    output straight into the strip: the same bytes, and the same failure,
    as one call over the whole stream, for whole, cut and corrupted
    streams over several pieces (the check sum's bytes too), the output
    bounded by the strip."""
    from ecgmm_torch.serve.tiff import _inflate
    rng = np.random.default_rng(5)
    plain = np.cumsum(rng.integers(-2, 3, 200_000)).astype(np.uint8)
    raw = zlib.compress(plain.tobytes(), 6)
    assert len(raw) > 3 * (1 << 14)
    cases = [(raw, plain.size), (raw, 5000), (raw[:40000], plain.size)]
    for at in list(rng.integers(2, len(raw), 12)) + [len(raw) - 2]:
        bad = bytearray(raw)
        bad[at] ^= 0xFF
        cases.append((bytes(bad), plain.size))
    for data, size in cases:
        out = np.zeros(size, np.uint8)
        n, error = _inflate(data, out)
        want, fails = _inflate_whole(data, size)
        assert (n, error is not None) == (len(want), fails)
        assert out[:n].tobytes() == want and not out[n:].any()


# ---------------------------------------------------------------- fixtures


def make_tiff_and_pnm_fixtures() -> dict:
    """The TIFF and PNM fixtures `chip_smoke.py` decodes on the card, built
    from the committed `strip.jpg` (decoded by the port): name -> bytes.
    The strip as YCbCr 2x2 JPEG-in-TIFF (strips of 16 rows, JPEGTables,
    Pillow's JPEG encoder at quality 75), a Group 4 scan of the strip
    binarised at grey 160 (Pillow's writer), the 250x200 crop
    strip[:, 600:800] as LZW with predictor 2 in 64x64 tiles, and the same
    crop as P6. Regenerate them, and their entries in
    `pillow_rgb_sha256.json`, with this function if `strip.jpg`
    changes."""
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        strip = decode_upload(f.read())
    crop = np.ascontiguousarray(strip[:, 600:800])
    grey = np.asarray(Image.fromarray(strip).convert("L"))
    scan = Image.fromarray(np.where(grey < 160, 0, 255).astype(np.uint8))
    tiles = [_chunk_bytes(t, "tiff_lzw", True, False)
             for t in _tiles(crop, 64, 64)]
    ppm = io.BytesIO()
    Image.fromarray(crop).save(ppm, format="PPM")
    return {
        "strip_ycbcr22.tif": _ycbcr_jpeg_tiff(strip, (2, 2), True, False,
                                              rows=16, quality=75),
        "strip_g4.tif": save(scan.convert("1"), compression="group4"),
        "crop_lzw_tiled.tif": build(
            _base_tags(200, 250, 8, 2, 3, 5, {317: (3, [2]),
                                              322: (3, [64]),
                                              323: (3, [64])}),
            tiles, tiled=True),
        "crop.ppm": ppm.getvalue(),
    }


def test_committed_tiff_and_pnm_fixtures():
    """The committed files are what `make_tiff_and_pnm_fixtures` builds,
    under 400 KB together; Pillow's decode of each has the hash in
    `pillow_rgb_sha256.json`, and the port's equals it."""
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    made = make_tiff_and_pnm_fixtures()
    assert sum(len(d) for d in made.values()) < 400_000
    for name, data in made.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
        assert assert_same(data) == "decoded"
        rgb = pillow(data)
        assert list(rgb.shape) == hashes[name]["shape"]
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
            hashes[name]["rgb_sha256"]
    assert Image.open(io.BytesIO(made["strip_g4.tif"])).tag_v2[259] == 4
