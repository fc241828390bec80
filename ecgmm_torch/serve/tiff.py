"""TIFF uploads: the first page of a TIFF or BigTIFF file as an (H, W, 3)
uint8 RGB array, as Pillow 12's `TiffImagePlugin`, with libtiff 4.7 under
it, gives it to the JAX handler's `.convert("RGB")`, and the file's
orientation.

Pillow reads the first directory itself (`read_ifd`, as
`ImageFileDirectory_v2` reads it: unknown value types skipped, a value
past the end of the file ends the directory, a tag of one value given
several keeps the first) and picks the image mode from its `OPEN_INFO`
table (`_OPEN_INFO` here), keyed on the byte order, photometric
interpretation, sample format, fill order, bits per sample and extra
samples. Uncompressed strips and tiles it decodes with its own raw
decoder (`_raw_tiles`); every other compression goes through libtiff,
which reads the directory its own way (`_LibtiffDir`) and each strip or
tile whole (`_libtiff_tiles`): PackBits, LZW (old-style codes too),
CCITT RLE (byte- and word-aligned), Group 3, Group 4 and ThunderScan in
C++ (`native/tiffdec.cpp`), ZSTD in C++ (`native/zstddec.cpp`, libzstd
1.5's streaming rules), Deflate through zlib, LZMA through the liblzma
Python's `lzma` module loads (driven as tif_lzma.c drives it),
horizontal differencing at 8, 16 and 32 bits and the floating-point
predictor, fill order 2, JPEG (compression 7) through the port's JPEG
decoder, each strip or tile a JPEG image of its own after the tables of
the JPEGTables tag, YCbCr converted to RGB by libjpeg's arithmetic, and
old-style JPEG (compression 6, `serve/ojpeg.py`): one JPEG stream
rebuilt for the whole image as tif_ojpeg.c rebuilds it. The samples are
then unpacked and converted as Pillow's unpackers and `.convert("RGB")`
treat each mode (`_unpack`, `imdecode._mode_to_rgb`).

YCbCr that is not JPEG-coded in one plane (old-style JPEG included)
Pillow reads through libtiff's RGBA reader, and so does the port
(`_rgba_image`).

No codec writes past the strip or tile buffer libtiff would fill, and that
buffer is bounded before it is allocated, as Pillow's TiffDecode.c and
libtiff bound it: a tile side or RowsPerStrip above INT_MAX and a buffer
of 2 GiB are refused, and so, in the RGBA reader, is a block of RGBA rows
of 2 GiB and a first tile above 100 MB whose bytes are under a thousandth
of it.

What Pillow refuses is refused with `BadRequest`. CIELAB, JPEG-in-TIFF
of other than 8 bits, and old-style JPEG in tiles or separate planes are
refused as unsupported (ROADMAP.md section 3); SGILog and WebP-in-TIFF
Pillow refuses here too.
"""

from __future__ import annotations

import ctypes
import lzma  # noqa: F401 (its extension loads the liblzma used here)
import struct
import zlib
from fractions import Fraction
from typing import Dict, Optional, Tuple

import numpy as np

from ecgmm_torch import native
from ecgmm_torch.serve import imdecode
from ecgmm_torch.serve.imdecode import _bad, _check_pixels, _unsupported
from ecgmm_torch.serve.ojpeg import OldJpeg
from ecgmm_torch.serve.wire import BadRequest

# PIL.TiffImagePlugin.COMPRESSION_INFO: the compressions Pillow names
# (any other value is refused), and those the port decodes
_COMPRESSION_NAMES = {
    1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
    50000: "zstd", 50001: "webp"}
_DECODED = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34925,
            50000}
# the codecs libtiff sets its predictor up for
_PREDICTED = (5, 8, 32946, 34925, 50000)
_ZSTD_ERRORS = {-50: "corruption detected", -51: "not enough data",
                -52: "checksum wrong", -53: "window too large",
                -54: "unknown frame prefix", -55: "unsupported frame "
                "parameter", -56: "dictionary wrong"}
_INT_MAX = 2 ** 31 - 1  # C's, which bounds Pillow's strip and tile buffers
_INFLATE_STEP = 1 << 14  # Deflate input fed at a time (<= 17 MiB out)
# the value types ImageFileDirectory_v2 loads: type -> (bytes a value, the
# struct code of a value; None: bytes, "s": text)
_TYPES = {1: (1, None), 2: (1, "s"), 3: (2, "H"), 4: (4, "L"), 5: (8, "LL"),
          6: (1, "b"), 7: (1, None), 8: (2, "h"), 9: (4, "l"),
          10: (8, "ll"), 11: (4, "f"), 12: (8, "d"), 13: (4, "L"),
          16: (8, "Q")}
# the tags read here that TiffTags gives one value (the others read here
# keep a tuple, one value or many)
_ONE = {256, 257, 259, 262, 266, 274, 277, 278, 282, 283, 284, 296, 317,
        322, 323, 347}
(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER, STRIP_OFFSETS,
 ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS, X_RES, Y_RES, PLANAR,
 RES_UNIT, PREDICTOR, COLOR_MAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS,
 TILE_COUNTS, EXTRA, SAMPLE_FORMAT, JPEG_TABLES, YCBCR_SUB, T4_OPTIONS,
 XMP) = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 282, 283,
         284, 296, 317, 320, 322, 323, 324, 325, 338, 339, 347, 530, 292,
         700)


def _open_info() -> Dict[tuple, Tuple[str, str]]:
    """PIL.TiffImagePlugin.OPEN_INFO for both byte orders: (photometric,
    sample format, fill order, bits per sample, extra samples) -> (mode,
    rawmode)."""
    table = {}

    def add(photo, fmt, fill, bits, extra, mode, raw):
        table[(photo, fmt, fill, bits, extra)] = (mode, raw)

    for photo, inv in ((0, "I"), (1, "")):
        add(photo, (1,), 1, (1,), (), "1", "1;" + inv if inv else "1")
        add(photo, (1,), 2, (1,), (), "1", f"1;{inv}R")
        for b in (2, 4):
            add(photo, (1,), 1, (b,), (), "L", f"L;{b}{inv}")
            add(photo, (1,), 2, (b,), (), "L", f"L;{b}{inv}R")
        add(photo, (1,), 1, (8,), (), "L", "L;I" if inv else "L")
        add(photo, (1,), 2, (8,), (), "L", "L;IR" if inv else "L;R")
    add(1, (2,), 1, (8,), (), "L", "L")
    add(1, (1,), 1, (12,), (), "I;16", "I;12")
    add(0, (1,), 1, (16,), (), "I;16", "I;16")
    add(1, (1,), 1, (16,), (), "I;16", "I;16")
    add(1, (1,), 2, (16,), (), "I;16", "I;16R")
    add(1, (2,), 1, (16,), (), "I", "I;16S")
    add(0, (3,), 1, (32,), (), "F", "F;32F")
    add(1, (1,), 1, (32,), (), "I", "I;32N")
    add(1, (2,), 1, (32,), (), "I", "I;32S")
    add(1, (3,), 1, (32,), (), "F", "F;32F")
    add(1, (1,), 1, (8, 8), (2,), "LA", "LA")
    add(2, (1,), 1, (8,) * 3, (), "RGB", "RGB")
    add(2, (1,), 2, (8,) * 3, (), "RGB", "RGB;R")
    add(2, (1,), 1, (8,) * 4, (), "RGBA", "RGBA")
    for n, x in ((1, "X"), (2, "XX"), (3, "XXX")):
        add(2, (1,), 1, (8,) * (3 + n), (0,) * n, "RGB", "RGB" + x)
    for n, x in ((1, ""), (2, "X"), (3, "XX")):
        add(2, (1,), 1, (8,) * (3 + n), (1,) + (0,) * (n - 1), "RGBA",
            "RGBa" + x)
        add(2, (1,), 1, (8,) * (3 + n), (2,) + (0,) * (n - 1), "RGBA",
            "RGBA" + x)
    add(2, (1,), 1, (8,) * 4, (999,), "RGBA", "RGBA")
    add(2, (1,), 1, (16,) * 3, (), "RGB", "RGB;16")
    add(2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16")
    add(2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16")
    add(2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16")
    add(2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16")
    for bits, raw in ((1, "P;1"), (2, "P;2"), (4, "P;4")):
        add(3, (1,), 1, (bits,), (), "P", raw)
        add(3, (1,), 2, (bits,), (), "P", raw + "R")
    add(3, (1,), 1, (8,), (), "P", "P")
    add(3, (1,), 1, (8, 8), (0,), "P", "PX")
    add(3, (1,), 1, (8, 8), (2,), "PA", "PA")
    add(3, (1,), 2, (8,), (), "P", "P;R")
    add(5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK")
    add(5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX")
    add(5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX")
    add(5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16")
    add(6, (1,), 1, (8,), (), "L", "L")
    add(6, (1,), 1, (8,) * 3, (), "RGB", "RGBX")
    add(8, (1,), 1, (8,) * 3, (), "LAB", "LAB")
    return table


_OPEN_INFO = _open_info()
# the byte-order-dependent keys: (MM, ...) -> the big-endian mode and
# rawmode; 16-bit rawmodes above carry their order where Pillow's do
_BIG_ENDIAN_16 = {("I;16", "I;16"): None, ("I;16", "I;16R"): None,
                  ("I;16", "I;12"): None, ("I", "I;32N"): None,
                  ("I", "I;16S"): ("I", "I;16BS"),
                  ("F", "F;32F"): ("F", "F;32BF"),
                  ("I", "I;32S"): ("I", "I;32BS")}
_MAX_SAMPLES = max(len(k[3]) for k in _OPEN_INFO)


def _mode_for(big: bool, key):
    """OPEN_INFO[(prefix,) + key], None where Pillow has no entry."""
    photo, fmt, fill, bits, extra = key
    if big and (photo, fmt, fill, bits, extra) == (1, (1,), 1, (16,), ()):
        return "I;16B", "I;16B"
    found = _OPEN_INFO.get(key)
    if found is None:
        return None
    mode, raw = found
    if raw in ("RGB;16", "RGBA;16", "RGBX;16", "RGBa;16", "CMYK;16"):
        return mode, raw + ("B" if big else "L")
    if big and found in _BIG_ENDIAN_16:
        return _BIG_ENDIAN_16[found]
    return found


# ------------------------------------------------------------ the directory


def _rational(num: int, den: int):
    # IFDRational: 0/0 and n/0 are legal and compare as NaN
    return Fraction(num, den) if den else float("nan")


def read_ifd(data: bytes, pos: int, end: str,
             bigtiff: bool) -> Dict[int, Tuple[int, bytes]]:
    """tag -> (type, value bytes) of the directory at `pos`, as
    ImageFileDirectory_v2.load reads it (for a TIFF file and for an EXIF
    block alike): an entry of a type it does not know, or of no value, is
    skipped; a duplicate replaces the earlier entry; the first entry cut
    by the end of the data, or whose values lie past it ("Truncated File
    Read"), ends the directory."""
    tags: Dict[int, Tuple[int, bytes]] = {}
    head, entry, word = (8, 20, 8) if bigtiff else (2, 12, 4)
    if pos + head > len(data):
        return tags
    (n,) = struct.unpack_from(end + ("Q" if bigtiff else "H"), data, pos)
    pos += head
    layout = end + ("HHQ" if bigtiff else "HHL")
    for _ in range(n):
        if pos + entry > len(data):
            return tags
        tag, typ, count = struct.unpack_from(layout, data, pos)
        field = data[pos + word + 4:pos + entry]
        pos += entry
        if typ not in _TYPES:
            continue
        size = count * _TYPES[typ][0]
        if size > word:
            (at,) = struct.unpack(end + ("Q" if bigtiff else "L"), field)
            value = data[at:at + size]
            if len(value) < size:
                return tags
        else:
            value = field[:size]
        if value:
            tags[tag] = (typ, value)
    return tags


def tag_value(end: str, tag: int, typ: int, data: bytes):
    """A tag's value as ImageFileDirectory_v2 holds it: an int, float,
    Fraction, str or bytes, or a tuple of them (a tag TiffTags gives one
    value keeps the first of several)."""
    unit, fmt = _TYPES[typ]
    count = len(data) // unit
    if fmt is None:
        values = [data]
    elif fmt == "s":
        text = data[:-1] if data.endswith(b"\0") else data
        values = [text.decode("latin-1", "replace")]
    elif len(fmt) == 2:
        v = struct.unpack(f"{end}{2 * count}{fmt[0]}", data)
        values = [_rational(a, b) for a, b in zip(v[::2], v[1::2])]
    else:
        values = list(struct.unpack(f"{end}{count}{fmt}", data))
    if tag in _ONE or typ == 1:
        return values[0]
    return tuple(values)


class Directory:
    """The first image file directory as Pillow's reader loads it."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 8 or data[:4] not in imdecode._TIFF_PREFIXES:
            raise _bad("not a TIFF file")
        self.big = data[:2] == b"MM"
        self.end = ">" if self.big else "<"
        # Pillow takes a file as BigTIFF only where its third byte is 43
        self.bigtiff = data[2] == 43
        if self.bigtiff:
            if len(data) < 16:
                raise _bad("truncated BigTIFF header")
            (first,) = struct.unpack(self.end + "Q", data[8:16])
        else:
            (first,) = struct.unpack(self.end + "L", data[4:8])
        if first == 0:
            raise _bad("a TIFF file with no image")
        if first >= 2 ** 63:
            raise _bad("a TIFF directory offset past 2^63")
        self.offset = first
        self.raw = read_ifd(data, first, self.end, self.bigtiff)

    def __contains__(self, tag: int) -> bool:
        return tag in self.raw

    def value(self, tag: int, default=None):
        if tag not in self.raw:
            return default
        typ, data = self.raw[tag]
        return tag_value(self.end, tag, typ, data)


# ------------------------------------------------------------ _setup


class Layout:
    """What TiffImageFile._setup derives from the directory."""

    palette = None  # 256 x 3, for modes P and PA


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _setup(ifd: Directory) -> Layout:
    """TiffImageFile._setup: the mode, the sizes and the tiles, with its
    refusals."""
    lay = Layout()
    if 0xBC01 in ifd:
        raise _unsupported("a Windows Media Photo file")
    compression = ifd.value(COMPRESSION, 1)
    if compression not in _COMPRESSION_NAMES:
        raise _bad(f"TIFF compression {compression!r} is unknown")
    lay.compression = compression
    lay.planar = ifd.value(PLANAR, 1)
    photo = ifd.value(PHOTOMETRIC, 0)
    if compression == 6:
        photo = 6
    lay.photo = photo
    fill = ifd.value(FILL_ORDER, 1)
    xsize, ysize = ifd.value(WIDTH), ifd.value(LENGTH)
    if xsize is None or ysize is None:
        raise _bad("a TIFF without its dimensions")
    if not _is_int(xsize) or not _is_int(ysize):
        raise _bad("a TIFF with invalid dimensions")
    lay.xsize, lay.ysize = xsize, ysize
    orientation = ifd.value(ORIENTATION)
    lay.orientation = orientation
    sample_format = ifd.value(SAMPLE_FORMAT, (1,))
    if isinstance(sample_format, tuple) and len(sample_format) > 1 and \
            max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = ifd.value(BITS, (1,))
    extra = ifd.value(EXTRA, ())
    bps_count = {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + _len(extra)
    spp = ifd.value(SAMPLES, 3 if compression == 6 and photo in (2, 6)
                    else 1)
    try:
        if spp > _MAX_SAMPLES:
            raise _bad("a TIFF of more samples per pixel than Pillow reads")
    except TypeError:
        raise _bad("a TIFF with an invalid SamplesPerPixel") from None
    if isinstance(bps, tuple):
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
    if not isinstance(bps, tuple) or len(bps) != spp:
        raise _bad("unknown data organization")
    key = (photo, _as_tuple(sample_format), fill, bps, _as_tuple(extra))
    found = _lookup(ifd.big, key)
    if found is None:
        raise _bad("a TIFF of an unknown pixel mode")
    mode, rawmode = found
    _check_resolution(ifd)
    lay.bps, lay.spp, lay.bps_count = bps, spp, bps_count
    lay.libtiff = compression != 1
    if lay.libtiff:
        if fill == 2:
            found = _lookup(ifd.big, key[:2] + (1,) + key[3:])
            mode, rawmode = found
        if photo == 6 and compression == 7 and lay.planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
        lay.tiles = None
    else:
        lay.tiles = _raw_tile_list(ifd, lay, rawmode)
    lay.mode, lay.rawmode = mode, rawmode
    if mode in ("P", "PA"):
        cmap = ifd.value(COLOR_MAP)
        if cmap is None:
            raise _bad("a palette TIFF without its ColorMap")
        lay.palette = _palette(cmap)
    if mode == "LAB":
        raise _unsupported("a TIFF in CIELAB (photometric 8)")
    return lay


def _len(v) -> int:
    return len(v) if isinstance(v, (tuple, bytes, str)) else 1


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,) if not isinstance(
        v, (bytes, str)) else v


def _lookup(big: bool, key):
    try:
        return _mode_for(big, key)
    except TypeError:  # an unhashable or odd value: no OPEN_INFO entry
        return None


def _check_resolution(ifd: Directory) -> None:
    """_setup's dpi fix-up, which raises TypeError (and Image.open then
    refuses the file) where a resolution in centimetres is no number."""
    xres, yres = ifd.value(X_RES, 1), ifd.value(Y_RES, 1)
    try:
        ok = bool(xres) and bool(yres)
    except (TypeError, ValueError):
        raise _bad("a TIFF with an unreadable resolution") from None
    if ok and ifd.value(RES_UNIT) == 3:
        for v in (xres, yres):
            if not isinstance(v, (int, float, Fraction)):
                raise _bad("a TIFF with an unreadable resolution")


def _palette(cmap) -> np.ndarray:
    """_setup's palette: o8(value // 256) of each ColorMap value (its low
    byte), read as "RGB;L" (all reds, then greens, then blues); entries
    past it are black, more than 256 of them refused ("invalid palette
    size"), a value that is no integer refused."""
    values = cmap if isinstance(cmap, tuple) else (cmap,)
    if not all(isinstance(v, (int, Fraction)) for v in values):
        raise _bad("a TIFF with an unreadable ColorMap")
    raw = bytes(int(v // 256) & 255 for v in values)
    n = len(raw) // 3
    if n > 256:
        raise _bad("a TIFF palette of more than 256 colours (Pillow: "
                   "invalid palette size)")
    pal = np.zeros((256, 3), np.uint8)
    table = np.frombuffer(raw[:3 * n], np.uint8).reshape(3, n).T[:256]
    pal[:len(table)] = table
    return pal


def _raw_tile_list(ifd: Directory, lay: Layout, rawmode: str):
    """_setup's tiles for Pillow's raw decoder: (extents, offset, rawmode,
    stride)."""
    xsize, ysize = lay.xsize, lay.ysize
    if STRIP_OFFSETS in ifd:
        offsets = ifd.value(STRIP_OFFSETS)
        h = ifd.value(ROWS_PER_STRIP, ysize)
        w = xsize
    elif TILE_OFFSETS in ifd:
        offsets = ifd.value(TILE_OFFSETS)
        w = ifd.value(TILE_WIDTH)
        h = ifd.value(TILE_LENGTH)
        if not _is_int(w) or not _is_int(h):
            raise _bad("a TIFF with invalid tile dimensions")
    else:
        raise _bad("unknown data organization")
    if not isinstance(offsets, tuple):
        offsets = (offsets,)
    if not all(_is_int(o) for o in offsets) or not _is_int(h):
        raise _bad("a TIFF with unreadable strip offsets")
    if w == xsize and h == ysize and lay.planar != 2:
        offsets = offsets[-1:]
    tiles = []
    x = y = layer = 0
    total_bits = sum(lay.bps)
    for offset in offsets:
        stride = w * total_bits / 8 if x + w > xsize else 0
        tile_raw = rawmode
        if lay.planar == 2:
            tile_raw = rawmode[layer] if layer < len(rawmode) else None
            stride /= lay.bps_count
        if h <= 0 or w <= 0:
            raise _bad("a TIFF with empty strips or tiles")
        tiles.append(((x, y, min(x + w, xsize), min(y + h, ysize)), offset,
                      tile_raw, int(stride)))
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y = 0
                layer += 1
    return tiles


# ------------------------------------------------------------ unpacking

_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)
# rawmode -> bits a pixel (Pillow's unpackers)
_RAW_BITS = {"1": 1, "1;I": 1, "1;R": 1, "1;IR": 1, "P;1": 1, "P;1R": 1,
             "L;2": 2, "L;2I": 2, "L;2R": 2, "L;2IR": 2, "P;2": 2, "P;2R": 2,
             "L;4": 4, "L;4I": 4, "L;4R": 4, "L;4IR": 4, "P;4": 4,
             "P;4R": 4, "L": 8, "L;I": 8, "L;R": 8, "P": 8, "P;R": 8,
             "R": 8, "G": 8, "B": 8, "A": 8, "C": 8, "M": 8, "Y": 8, "K": 8,
             "PX": 16, "PA": 16, "LA": 16, "I;12": 12, "I;16": 16,
             "I;16B": 16, "I;16N": 16, "I;16R": 16, "I;16S": 16,
             "I;16BS": 16, "I;32N": 32, "I;32S": 32, "I;32BS": 32,
             "F;32F": 32, "F;32BF": 32, "RGB": 24, "RGB;R": 24, "RGBX": 32,
             "RGBA": 32, "RGBa": 32, "RGBXX": 40, "RGBaX": 40, "RGBAX": 40,
             "RGBXXX": 48, "RGBaXX": 48, "RGBAXX": 48, "CMYK": 32,
             "CMYKX": 40, "CMYKXX": 48}
for _r in ("RGB;16", "RGBA;16", "RGBX;16", "RGBa;16", "CMYK;16"):
    for _e in "BLN":
        _RAW_BITS[_r + _e] = 16 * (3 if _r == "RGB;16" else 4)
# the (mode, rawmode) pairs Pillow has an unpacker for
_UNPACKERS = {
    "1": {"1", "1;I", "1;R", "1;IR"},
    "L": {"L;2", "L;2I", "L;2R", "L;2IR", "L;4", "L;4I", "L;4R", "L;4IR",
          "L", "L;I", "L;R"},
    "P": {"P;1", "P;2", "P;4", "P", "PX", "P;R", "L"},
    "PA": {"PA"},
    "LA": {"LA"},
    "I;16": {"I;12", "I;16", "I;16N", "I;16R"},
    "I;16B": {"I;16B", "I;16N"},
    "I": {"I;16S", "I;16BS", "I;32N", "I;32S", "I;32BS"},
    "F": {"F;32F", "F;32BF"},
    "RGB": {"RGB", "RGB;R", "RGBX", "RGBXX", "RGBXXX", "R", "G", "B"}
    | {f"{r}{e}" for r in ("RGB;16", "RGBX;16") for e in "BLN"},
    "RGBA": {"RGBA", "RGBa", "RGBaX", "RGBaXX", "RGBAX", "RGBAXX", "RGBX",
             "R", "G", "B", "A"}
    | {f"{r}{e}" for r in ("RGBA;16", "RGBa;16") for e in "BLN"},
    "CMYK": {"CMYK", "CMYKX", "CMYKXX", "C", "M", "Y", "K"}
    | {f"CMYK;16{e}" for e in "BLN"},
}
# the fill-order-2 rawmodes: the rawmode of the bytes bit-reversed
_BIT_REVERSED = {"1;R": "1", "1;IR": "1;I", "L;2R": "L;2", "L;2IR": "L;2I",
                 "L;4R": "L;4", "L;4IR": "L;4I", "L;R": "L", "I;16R": "I;16",
                 "P;R": "P", "RGB;R": "RGB"}
_BAND = {"R": 0, "G": 1, "B": 2, "A": 3, "C": 0, "M": 1, "Y": 2, "K": 3}
_MULTIBAND = {"LA", "PA", "RGB", "RGBA", "CMYK"}


def _blank(mode: str, height: int, width: int) -> np.ndarray:
    """Image.core.new: zeros; four bytes a pixel for a multiband mode (an
    LA pixel L, L, L, A), but three for RGB, whose fourth is never read."""
    if mode in _MULTIBAND:
        return np.zeros((height, width, 3 if mode == "RGB" else 4),
                        np.uint8)
    dtype = {"I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
             "F": np.float32}.get(mode, np.uint8)
    return np.zeros((height, width), dtype)


def _bits(rows: np.ndarray, nbits: int, width: int) -> np.ndarray:
    """Samples of `nbits` (1, 2, 4) packed first bit highest."""
    unpacked = np.unpackbits(rows, axis=1)[:, :width * nbits]
    if nbits == 1:
        return unpacked
    weights = (1 << np.arange(nbits - 1, -1, -1)).astype(np.uint8)
    return (unpacked.reshape(rows.shape[0], width, nbits)
            * weights).sum(axis=2, dtype=np.uint8)


def _u16(rows: np.ndarray, width: int, n: int, order: str) -> np.ndarray:
    """(R, width, n) 16-bit samples in byte order `order` ('<', '>')."""
    return rows[:, :2 * n * width].copy().view(order + "u2").reshape(
        rows.shape[0], width, n)


def _unpack(mode: str, rawmode: str, rows: np.ndarray, width: int):
    """Pillow's unpacker for (mode, rawmode) over `rows` ((R, row bytes)
    uint8): the image's pixels, or (band, values) for a one-band
    unpacker of a multiband mode."""
    if rawmode in _BAND and mode in ("RGB", "RGBA", "CMYK"):
        return _BAND[rawmode], rows[:, :width]
    if rawmode in _BIT_REVERSED:  # fill order 2: each byte's bits reversed
        return _unpack(mode, _BIT_REVERSED[rawmode], _REVERSED[rows], width)
    r = rows.shape[0]
    if mode == "1":
        v = _bits(rows, 1, width)
        return (v if rawmode == "1" else 1 - v) * np.uint8(255)
    if mode in ("L", "P"):
        if rawmode in ("L", "P", "L;I"):
            v = rows[:, :width]
            return 255 - v if rawmode == "L;I" else v.copy()
        if rawmode in ("PX", "PA"):
            return rows[:, :2 * width:2].copy()
        nbits = _RAW_BITS[rawmode]
        v = _bits(rows, nbits, width)
        if mode == "P":
            return v
        scale = {2: 0x55, 4: 0x11}[nbits]
        if rawmode.endswith("I"):
            v = (1 << nbits) - 1 - v
        return v * np.uint8(scale)
    if mode in ("LA", "PA"):
        px = rows[:, :2 * width].reshape(r, width, 2)
        out = np.empty((r, width, 4), np.uint8)
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
        return out
    if mode in ("I;16", "I;16B"):
        if rawmode == "I;12":
            return _i12(rows, width)
        order = ">" if rawmode == "I;16B" else "<"
        return _u16(rows, width, 1, order)[..., 0].astype(np.uint16)
    if mode == "I":
        fmt = {"I;16S": "<i2", "I;16BS": ">i2", "I;32N": "<i4",
               "I;32S": "<i4", "I;32BS": ">i4"}[rawmode]
        n = int(fmt[-1])
        return rows[:, :n * width].copy().view(fmt).reshape(
            r, width).astype(np.int32)
    if mode == "F":
        fmt = "<f4" if rawmode == "F;32F" else ">f4"
        return rows[:, :4 * width].copy().view(fmt).reshape(
            r, width).astype(np.float32)
    # RGB, RGBA, CMYK: 8- or 16-bit samples, the first 3 or 4 kept
    if ";16" in rawmode:
        order = {"B": ">", "L": "<", "N": "<"}[rawmode[-1]]
        n = _RAW_BITS[rawmode] // 16
        px = (_u16(rows, width, n, order) >> 8).astype(np.uint8)
        rawmode = rawmode[:rawmode.index(";")]
    else:
        n = _RAW_BITS[rawmode] // 8
        px = rows[:, :n * width].reshape(r, width, n)
        if mode == "RGB":  # the fourth byte is never read
            return px[..., :3]
    out = np.empty((r, width, 4), np.uint8)
    k = 4 if mode in ("RGBA", "CMYK") else 3
    out[..., :k] = px[..., :k]
    if k == 3:
        out[..., 3] = 255
    if rawmode.startswith("RGBa"):
        out = _unpremultiply(out)
    if mode == "RGBA" and rawmode == "RGBX":
        out[..., 3] = 255
    return out


def _i12(rows: np.ndarray, width: int) -> np.ndarray:
    """unpackI12_I16: 12-bit samples, first bit highest."""
    r = rows.shape[0]
    padded = np.zeros((r, (width + 1) // 2 * 3), np.uint8)
    take = min(padded.shape[1], rows.shape[1])
    padded[:, :take] = rows[:, :take]
    t = padded.reshape(r, -1, 3).astype(np.uint16)
    a = (t[..., 0] << 4) | (t[..., 1] >> 4)
    b = ((t[..., 1] & 15) << 8) | t[..., 2]
    return np.stack([a, b], axis=2).reshape(r, -1)[:, :width]


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """unpackRGBa: each colour * 255 // alpha, clipped (0 where alpha is
    0)."""
    a = px[..., 3:4].astype(np.int32)
    c = px[..., :3].astype(np.int32)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.where(a == 0, 0, np.minimum(c * 255 // np.maximum(a, 1), 255))
    v = np.where(a == 255, c, v)
    out = px.copy()
    out[..., :3] = v.astype(np.uint8)
    return out


def _store(img: np.ndarray, extents, values) -> None:
    x0, y0, x1, y1 = extents
    if isinstance(values, tuple):
        band, v = values
        img[y0:y1, x0:x1, band] = v[:y1 - y0, :x1 - x0]
    elif values.ndim == 3:
        k = min(values.shape[2], img.shape[2])
        img[y0:y1, x0:x1, :k] = values[:y1 - y0, :x1 - x0, :k]
    else:
        img[y0:y1, x0:x1] = values[:y1 - y0, :x1 - x0]


# ------------------------------------------------------------ Pillow's raw


def _raw_tiles(data: bytes, lay: Layout) -> np.ndarray:
    """ImageFile.load over _setup's raw tiles: sorted by offset, runs of
    tiles that differ only in offset cut to the last; each tile's rows
    read from its offset (a stride past the row's bytes skipped between
    rows) and unpacked; data that ends before a tile's last row is
    "image file is truncated"."""
    img = _blank(lay.mode, lay.ysize, lay.xsize)
    tiles = sorted(lay.tiles, key=lambda t: t[1])
    kept = []
    for t in tiles:
        if kept and (kept[-1][0], kept[-1][2], kept[-1][3]) == \
                (t[0], t[2], t[3]):
            kept[-1] = t
        else:
            kept.append(t)
    if not kept:
        raise _bad("a TIFF with no strips")
    for extents, offset, rawmode, stride in kept:
        x0, y0, x1, y1 = extents
        if rawmode is None or rawmode not in _UNPACKERS.get(lay.mode, ()):
            raise _bad(f"no Pillow unpacker for mode {lay.mode} from "
                       f"{rawmode}")
        width, height = x1 - x0, y1 - y0
        if width <= 0 or height <= 0 or x1 > lay.xsize or y1 > lay.ysize:
            raise _bad("a TIFF tile outside the image")
        nbytes = (width * _RAW_BITS[rawmode] + 7) // 8
        skip = stride - nbytes if stride else 0
        if skip < 0:
            raise _bad("a TIFF tile's stride is shorter than its rows")
        step = nbytes + skip
        if offset < 0 or offset + (height - 1) * step + nbytes > len(data):
            raise _bad("truncated TIFF image data (Pillow: image file is "
                       "truncated)")
        buf = np.frombuffer(data, np.uint8, (height - 1) * step + nbytes,
                            offset)
        rows = np.lib.stride_tricks.as_strided(
            buf, (height, nbytes), (step, 1))
        _store(img, extents, _unpack(lay.mode, rawmode, rows, width))
    return img


# ------------------------------------------------------------ libtiff


# libtiff's value types: type -> (bytes a value, struct code of an integer
# type; None where libtiff reads no integer from it)
_LT_TYPES = {1: (1, "B"), 2: (1, None), 3: (2, "H"), 4: (4, "L"),
             5: (8, None), 6: (1, "b"), 7: (1, None), 8: (2, "h"),
             9: (4, "l"), 10: (8, None), 11: (4, None), 12: (8, None),
             13: (4, "L"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}


class _Unreadable(Exception):
    """A tag libtiff cannot read (TIFFReadDirEntryErr*)."""


class _LibtiffDir:
    """The directory as libtiff reads it (TIFFFetchDirectory): every entry
    in the file (a directory that runs past the end fails), the first of
    each tag counting (later duplicates are ignored)."""

    def __init__(self, ifd: Directory):
        data, self.end = ifd.data, ifd.end
        self.data, self.bigtiff = data, ifd.bigtiff
        head, entry = (8, 20) if self.bigtiff else (2, 12)
        pos = ifd.offset
        if pos + head > len(data):
            raise _bad("libtiff: cannot read the TIFF directory count")
        (n,) = struct.unpack_from(self.end + ("Q" if self.bigtiff else "H"),
                                  data, pos)
        if n > 4096:
            raise _bad("libtiff: a TIFF directory of more than 4096 entries")
        if pos + head + n * entry > len(data):
            raise _bad("libtiff: cannot read the TIFF directory")
        self.entries = []
        self.first = {}
        layout = self.end + ("HHQ" if self.bigtiff else "HHL")
        for i in range(n):
            at = pos + head + i * entry
            tag, typ, count = struct.unpack_from(layout, data, at)
            field = data[at + entry // 2 + 2:at + entry]
            self.entries.append((tag, typ, count))
            self.first.setdefault(tag, (typ, count, field))

    def __contains__(self, tag: int) -> bool:
        return tag in self.first

    def array(self, tag: int, limit: Optional[int] = None,
              top: int = 2 ** 64 - 1) -> Optional[tuple]:
        """TIFFReadDirEntry*Array(WithLimit): the first `limit` integer
        values, each within 0..top; None where the tag is absent."""
        if tag not in self.first:
            return None
        typ, count, field = self.first[tag]
        if typ not in _LT_TYPES or _LT_TYPES[typ][1] is None:
            raise _Unreadable(f"type {typ}")
        unit, fmt = _LT_TYPES[typ]
        n = count if limit is None else min(count, limit)
        word = 8 if self.bigtiff else 4
        if min(count, 10) * unit <= word:
            raw = field[:n * unit]
        else:
            (at,) = struct.unpack(self.end + ("Q" if self.bigtiff else "L"),
                                  field)
            raw = self.data[at:at + n * unit]
            if len(raw) < n * unit:
                raise _Unreadable("past the end of the file")
        values = struct.unpack(f"{self.end}{n}{fmt}", raw)
        if any(v < 0 or v > top for v in values):
            raise _Unreadable("a value out of range")
        return values

    def raw_bytes(self, tag: int) -> Optional[bytes]:
        """A byte-typed tag's value (JPEGTables), None where it is absent,
        empty or unreadable."""
        if tag not in self.first:
            return None
        typ, count, field = self.first[tag]
        if typ not in (1, 2, 6, 7) or count == 0:
            return None
        word = 8 if self.bigtiff else 4
        if count <= word:
            return field[:count]
        (at,) = struct.unpack(self.end + ("Q" if self.bigtiff else "L"),
                              field)
        value = self.data[at:at + count]
        return value if len(value) == count else None

    def floats(self, tag: int, count: int):
        """A float field of exactly `count` values as libtiff reads it
        (TIFFReadDirEntryFloatArray: a rational n/d as float32 n / d, 0
        where d is 0), None where it is absent or unreadable."""
        if tag not in self.first or self.first[tag][1] != count:
            return None
        typ, _, field = self.first[tag]
        unit = _LT_TYPES.get(typ, (0, None))[0]
        if typ not in (1, 3, 4, 5, 6, 8, 9, 10, 11, 12, 16, 17):
            return None
        word = 8 if self.bigtiff else 4
        if count * unit <= word:
            raw = field[:count * unit]
        else:
            (at,) = struct.unpack(self.end + ("Q" if self.bigtiff else "L"),
                                  field)
            raw = self.data[at:at + count * unit]
            if len(raw) < count * unit:
                return None
        if typ in (5, 10):
            v = struct.unpack(f"{self.end}{2 * count}"
                              f"{'L' if typ == 5 else 'l'}", raw)
            return np.array([np.float32(a) / np.float32(b) if b else 0.0
                             for a, b in zip(v[::2], v[1::2])], np.float32)
        fmt = {11: "f", 12: "d"}.get(typ) or _LT_TYPES[typ][1]
        return np.array(struct.unpack(f"{self.end}{count}{fmt}", raw),
                        np.float64).astype(np.float32)

    def scalar(self, tag: int, default=None, top: int = 2 ** 32 - 1):
        """TIFFReadDirEntryShort/Long: exactly one value."""
        if tag not in self.first:
            return default
        if self.first[tag][1] != 1:
            raise _Unreadable("a count other than 1")
        return self.array(tag, top=top)[0]

    def per_sample(self, tag: int, spp: int, default):
        """A SHORT of one value, or of one per sample that agree
        (TIFFReadDirEntryPersampleShort)."""
        if tag not in self.first:
            return default
        count = self.first[tag][1]
        if count == 1:
            return self.scalar(tag, top=65535)
        if count < spp:
            raise _Unreadable("fewer values than samples")
        values = self.array(tag, top=65535)
        if len(set(values[:spp])) > 1:
            raise _Unreadable("different values per sample")
        return values[0]

    def estimate_counts(self, offsets, spp: int, planar: int) -> tuple:
        """EstimateStripByteCounts for compressed data: the file's size less
        the directory and its out-of-line values, a plane's share of it a
        strip, the last strip cut at the end of the file."""
        head, entry, word = (16, 20, 8) if self.bigtiff else (8, 12, 4)
        space = head + (8 if self.bigtiff else 2) + len(self.entries) * entry \
            + word
        for _, typ, count in self.entries:
            if typ not in _LT_TYPES:
                raise _bad("libtiff: a tag of an unknown type")
            size = _LT_TYPES[typ][0] * count
            space += size if size > word else 0
        filesize = len(self.data)
        space = filesize if filesize < space else filesize - space
        if planar == 2:
            space //= spp
        counts = [space] * len(offsets)
        last = offsets[-1]
        if last + counts[-1] > filesize:
            counts[-1] = filesize - last if last < filesize else 0
        return tuple(counts)


class _Libtiff:
    """The fields TIFFReadDirectory sets for a strip or tile read, with
    its refusals (a tag it must read and cannot fails the directory, and
    Pillow's decoder with it; a tag it may skip falls back to its
    default)."""

    def __init__(self, ifd: Directory, lay: Layout):
        d = _LibtiffDir(ifd)
        try:
            self._read(d, lay)
        except _Unreadable as e:
            raise _bad(f"libtiff cannot read the TIFF directory ({e})") \
                from None

    @staticmethod
    def _soft(read, default):
        try:
            return read()
        except _Unreadable:
            return default

    def _read(self, d: _LibtiffDir, lay: Layout) -> None:
        self.big_endian = d.end == ">"
        self.no_eol = np.zeros(1, np.int32)  # Group 3's FAXMODE_NOEOL
        self.spp = d.scalar(SAMPLES, 1, top=65535)
        if self.spp == 0:
            raise _bad("libtiff: SamplesPerPixel 0")
        self.compression = d.per_sample(COMPRESSION, self.spp, 1)
        if self.compression == 6:
            # TIFFReadDirectory's old-style JPEG fixes: no photometric, or
            # RGB, is YCbCr; no SamplesPerPixel is 3 for YCbCr, 1 for grey
            photo = self._soft(lambda: d.scalar(PHOTOMETRIC, None, 65535),
                               None)
            photo = 6 if photo in (None, 2) else photo
            if SAMPLES not in d and photo in (0, 1, 6):
                self.spp = 3 if photo == 6 else 1
        self.width = d.scalar(WIDTH)
        self.length = d.scalar(LENGTH)
        tw = d.scalar(TILE_WIDTH)
        tl = d.scalar(TILE_LENGTH)
        self.planar = d.scalar(PLANAR, 1, top=65535)
        if self.planar not in (1, 2):
            raise _bad(f"libtiff: PlanarConfiguration {self.planar}")
        rps = d.scalar(ROWS_PER_STRIP, 2 ** 32 - 1)
        if rps == 0:
            raise _bad("libtiff: RowsPerStrip 0")
        extra = d.array(EXTRA, top=65535) or ()
        if len(extra) > self.spp or any(v > 2 and (i < len(extra) - 1 or
                                                   v != 999)
                                        for i, v in enumerate(extra)):
            raise _bad("libtiff: bad ExtraSamples")
        self.extra = tuple(2 if v == 999 else v for v in extra)
        if self.width is None or self.length is None:
            raise _bad("libtiff: a TIFF directory without its dimensions")
        if (self.width, self.length) != (lay.xsize, lay.ysize):
            raise _bad("libtiff reads other dimensions than Pillow")
        self.tiled = tw is not None or tl is not None
        if self.tiled:
            self.tw, self.tl = tw or 0, tl or 0
            if not self.tw or not self.tl:
                raise _bad("libtiff: cannot handle zero number of tiles")
            n = -(-self.width // self.tw) * -(-self.length // self.tl)
        else:
            self.rps = rps
            n = 1 if rps == 2 ** 32 - 1 else -(-self.length // rps)
        if self.planar == 2:
            n *= self.spp
        if n == 0:
            raise _bad("libtiff: cannot handle zero number of strips")
        self.n = n
        self.bits = d.per_sample(BITS, self.spp,
                                 8 if self.compression == 6 else 1)
        self.sample_format = d.per_sample(SAMPLE_FORMAT, self.spp, 1)
        if not 1 <= self.sample_format <= 6:
            raise _bad(f"libtiff: SampleFormat {self.sample_format}")
        self.photo = self._soft(lambda: d.scalar(PHOTOMETRIC, None, 65535),
                                None)
        if self.compression == 6 and self.photo in (None, 2):
            self.photo = 6
        fill = self._soft(lambda: d.scalar(FILL_ORDER, 1, 65535), 1)
        self.fill = fill if fill in (1, 2) else 1
        self.predictor = 1
        if self.compression in _PREDICTED:
            self.predictor = self._soft(
                lambda: d.scalar(PREDICTOR, 1, 65535), 1)
        self.t4 = 0
        if self.compression == 3:
            self.t4 = self._soft(lambda: d.scalar(T4_OPTIONS, 0), 0)
        self.ycbcr_sub = None
        self.jpeg_tables = None
        sub = self._soft(lambda: d.array(YCBCR_SUB, top=65535), None)
        if sub is not None and d.first[YCBCR_SUB][1] == 2:
            self.ycbcr_sub = sub
        if self.compression == 7:
            self.jpeg_tables = d.raw_bytes(JPEG_TABLES)
        self.ojpeg_tags = {}
        if self.compression == 6:
            for tag in (513, 514, 515):
                self.ojpeg_tags[tag] = self._soft(lambda: d.scalar(tag), None)
            for tag in (519, 520, 521):
                self.ojpeg_tags[tag] = self._soft(lambda: d.array(tag), None)
        self.luma = d.floats(529, 3)
        self.ref_bw = d.floats(532, 6)
        if self.photo == 3 and self.bits < 8:
            # a ColorMap of another count than 3 * 2^bits, or unreadable, is
            # ignored; a palette image under 8 bits without one fails
            cmap = self._soft(lambda: d.array(COLOR_MAP, top=65535), None)
            if cmap is None or d.first[COLOR_MAP][1] != 3 << self.bits:
                raise _bad("libtiff: a palette TIFF without a readable "
                           "ColorMap")
        # StripOffsets and TileOffsets are one field to libtiff
        off_tag = TILE_OFFSETS if TILE_OFFSETS in d else STRIP_OFFSETS
        cnt_tag = TILE_COUNTS if TILE_COUNTS in d else STRIP_COUNTS
        if off_tag not in d and not (self.compression == 6 and n == 1
                                     and not self.tiled):
            # (old-style JPEG of one strip may keep it all in the JPEG
            # interchange format stream)
            raise _bad("libtiff: a TIFF without its strip offsets")
        off = d.array(off_tag, n) if off_tag in d else (0,)
        self.offsets = tuple(off) + (0,) * (n - len(off))
        one_a_plane = n == (self.spp if self.planar == 2 else 1)
        self.counts_read = cnt_tag in d
        if self.compression == 6:
            # TIFFReadDirectory leaves old-style JPEG's byte counts as the
            # file has them (none where the tag is missing)
            cnt = d.array(cnt_tag, n) if cnt_tag in d else ()
            self.counts = tuple(cnt) + (0,) * (n - len(cnt))
        elif cnt_tag not in d:
            if not one_a_plane or self.tiled:
                raise _bad("libtiff: a TIFF without StripByteCounts")
            self.counts = d.estimate_counts(self.offsets, self.spp,
                                            self.planar)
        else:
            cnt = d.array(cnt_tag, n)
            self.counts = tuple(cnt) + (0,) * (n - len(cnt))
            if n == 1 and not self.tiled and self.offsets[0] and \
                    not self.counts[0]:
                self.counts = d.estimate_counts(self.offsets, self.spp,
                                                self.planar)
        samples = self.spp if self.planar == 1 else 1
        if self.tiled:
            self.rowbytes = -(-self.tw * self.bits * samples // 8)
        else:
            self.rowbytes = -(-self.width * self.bits * samples // 8)

    def raw(self, data: bytes, i: int) -> bytes:
        """TIFFFillStrip: the strip's bytes, bit-reversed for fill order 2
        (but for CCITT, whose decoder reads either order); old-style JPEG
        reads its own bytes (TIFF_NOREADRAW), so nothing for it."""
        self.index = i
        if self.compression == 6:
            return b""
        count, offset = self.counts[i], self.offsets[i]
        if count == 0:
            raise _bad(f"libtiff: invalid strip byte count 0, strip {i}")
        if count > len(data) or offset > len(data) - count:
            raise _bad(f"truncated TIFF (libtiff: read error on strip {i})")
        raw = data[offset:offset + count]
        self.parity = offset & 1  # where Pillow's mapped file puts it
        if self.fill == 2 and self.compression not in (2, 3, 4, 32771):
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        return raw


def _predict(buf: np.ndarray, lt: _Libtiff, rows: int, width: int) -> None:
    """The predictor undone row by row, in place; `buf` holds `rows` rows
    of `lt.rowbytes`: horizontal differencing (horAcc8, 16 and 32, on
    samples in the host's order) or libtiff's floating-point predictor
    (fpAcc: the row's bytes differenced with the samples' stride, each
    sample's bytes stored most significant first, a plane a byte)."""
    samples = lt.spp if lt.planar == 1 else 1
    block = buf[:rows * lt.rowbytes]
    if lt.predictor == 2:
        dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[lt.bits]
        v = block.view(dtype).reshape(rows, width, samples)
        np.cumsum(v, axis=1, dtype=dtype, out=v)
        return
    size = lt.bits // 8
    v = block.reshape(rows, -1, samples)
    np.cumsum(v, axis=1, dtype=np.uint8, out=v)
    planes = block.reshape(rows, size, -1)[:, ::-1]
    block[:] = planes.transpose(0, 2, 1).reshape(-1)


def _decode_chunk(lib, lt: _Libtiff, raw: bytes, out: np.ndarray, rows: int,
                  width: int, strict: bool = True) -> None:
    """One strip or tile into `out` (its libtiff size): the codec, the
    byte swap of 16-bit samples to the host's order, the predictor.
    `strict=False`: a codec's failure keeps what it wrote (libtiff's RGBA
    reader goes on past a strip that fails)."""
    try:
        _codec(lib, lt, raw, out, rows, width)
    except BadRequest:
        if strict:
            raise
        return
    uses_predictor = lt.compression in _PREDICTED and lt.predictor != 1
    if lt.big_endian and lt.bits in (16, 32) and not (
            uses_predictor and lt.predictor == 3):
        # libtiff's _TIFFSwab16BitData / 32BitData: samples in host order
        out.view(f">u{lt.bits // 8}").byteswap(inplace=True)
    if uses_predictor:
        _predict(out, lt, rows, width)


def _codec(lib, lt: _Libtiff, raw: bytes, out: np.ndarray, rows: int,
           width: int) -> None:
    size = out.size
    c = lt.compression
    if c == 1:  # DumpModeDecode, where libtiff reads no compression
        if len(raw) < size:
            raise _bad("libtiff: not enough data for scanline")
        out[:] = np.frombuffer(raw, np.uint8, size)
    elif c not in _DECODED:
        raise _bad(f"libtiff reads compression {c}, which Pillow does not")
    elif c == 32773:
        status = lib.ecgmm_tiff_packbits(raw, len(raw), out.ctypes.data,
                                         size)
        if status:
            raise _bad("truncated PackBits strip (libtiff: not enough data "
                       "for scanline)")
    elif c == 5:
        status = lib.ecgmm_tiff_lzw(raw, len(raw), out.ctypes.data, size)
        if status:
            raise _bad("bad or truncated LZW strip (libtiff: "
                       + ("not enough data" if status == -32 else
                          "using code not yet in table") + ")")
    elif c in (8, 32946):
        got, error = _inflate(raw, out)
        if error is not None:
            raise _bad(f"bad Deflate strip (libtiff: {error})")
        if got < size:
            raise _bad("truncated Deflate strip (libtiff: not enough data)")
    elif c == 34925:
        got, error = _unxz(raw, out)
        if got < size:
            raise _bad(f"bad or truncated LZMA strip (libtiff: {error})")
    elif c == 50000:
        written = np.zeros(1, np.int64)
        status = lib.ecgmm_zstd_strip(raw, len(raw), out.ctypes.data, size,
                                      written.ctypes.data)
        if status:
            out[int(written[0]):] = 0  # ZSTDDecode zeroes what is left
            raise _bad(f"bad or truncated ZSTD strip (libtiff: "
                       f"{_ZSTD_ERRORS.get(status, status)})")
    elif c in (2, 3, 4, 32771):
        if c == 32771:
            status = lib.ecgmm_tiff_fax_rlew(raw, len(raw), int(lt.fill == 2),
                                             width, rows, lt.rowbytes,
                                             out.ctypes.data, lt.parity)
        else:
            status = lib.ecgmm_tiff_fax(raw, len(raw), c, lt.t4,
                                        int(lt.fill == 2), width, rows,
                                        lt.rowbytes, out.ctypes.data,
                                        lt.no_eol.ctypes.data)
        if status:
            raise _bad("bad or truncated CCITT strip (libtiff: premature "
                       "EOF)")
    elif c == 6:
        lt.ojpeg.strip(lt.index, out, rows)
    elif c == 32809:
        status = lib.ecgmm_tiff_thunder(raw, len(raw), lt.width, rows,
                                        lt.rowbytes, out.ctypes.data)
        if status:
            raise _bad("bad or truncated ThunderScan strip (libtiff: not "
                       "enough or too much data)")


class _LzmaStream(ctypes.Structure):
    """liblzma's lzma_stream (LZMA_STREAM_INIT: all zeros)."""
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_uint64), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4),
                ("reserved_int", ctypes.c_uint64 * 2),
                ("reserved_size", ctypes.c_size_t * 2),
                ("reserved_enum", ctypes.c_int * 2)]


_LZMA_ERRORS = {5: "cannot allocate memory", 6: "memory limit reached",
                7: "unknown file format", 8: "unsupported options",
                9: "corrupt data", 10: "no progress possible"}


def _liblzma():
    """The liblzma Python's `lzma` module is built on (its extension has
    loaded it): libtiff's tif_lzma.c drives it through lzma_stream_decoder
    and lzma_code, which that module's API does not expose as libtiff uses
    them (the output of a call that ends in an error)."""
    lib = ctypes.CDLL("liblzma.so.5")
    lib.lzma_stream_decoder.argtypes = [ctypes.POINTER(_LzmaStream),
                                        ctypes.c_uint64, ctypes.c_uint32]
    lib.lzma_code.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_int]
    lib.lzma_end.argtypes = [ctypes.POINTER(_LzmaStream)]
    return lib


def _unxz(raw: bytes, out: np.ndarray) -> Tuple[int, str]:
    """tif_lzma.c's LZMADecode: liblzma's .xz stream decoder, no memory
    limit, the integrity check verified where the stream reaches it, run
    until the strip is full (an error after that is reported and
    ignored), the stream ends or it fails. (bytes written, why it
    stopped)."""
    lib = _liblzma()
    st = _LzmaStream()
    status = lib.lzma_stream_decoder(ctypes.byref(st), 2 ** 64 - 1, 0)
    if status:
        return 0, _LZMA_ERRORS.get(status, f"error {status}")
    src = ctypes.create_string_buffer(raw, len(raw))
    st.next_in, st.avail_in = ctypes.addressof(src), len(raw)
    st.next_out, st.avail_out = out.ctypes.data, out.size
    why = "not enough data"
    try:
        while st.avail_out > 0:
            status = lib.lzma_code(ctypes.byref(st), 0)
            if status == 1:  # LZMA_STREAM_END
                break
            if status:
                why = _LZMA_ERRORS.get(status, f"error {status}")
                break
    finally:
        lib.lzma_end(ctypes.byref(st))
    return out.size - st.avail_out, why


def _inflate(raw: bytes, out: np.ndarray) -> Tuple[int, Optional[str]]:
    """(bytes written, None), or where the stream is corrupt (bytes
    written, zlib's message): `raw` inflated into `out` and no further, fed
    `_INFLATE_STEP` bytes at a time, each piece's output written straight
    to `out`. At a corrupt byte, `out` keeps what inflate writes before it:
    the stream is fed again up to the failing piece, then a byte at a time,
    and all but that byte's own output is kept."""
    z = zlib.decompressobj()
    pos = 0
    for start in range(0, len(raw), _INFLATE_STEP):
        if pos == out.size:
            break
        try:
            pos = _feed(z, raw[start:start + _INFLATE_STEP], out, pos)
        except zlib.error:
            break
    else:
        return pos, None
    if pos == out.size:
        return pos, None
    z, pos = zlib.decompressobj(), 0
    for i in range(0, start, _INFLATE_STEP):
        pos = _feed(z, raw[i:min(i + _INFLATE_STEP, start)], out, pos)
    for i in range(start, min(start + _INFLATE_STEP, len(raw))):
        try:
            pos = _feed(z, raw[i:i + 1], out, pos)
        except zlib.error as e:
            return pos, str(e)
    return pos, "invalid stream"  # the piece failed whole, not a byte


def _feed(z, data: bytes, out: np.ndarray, pos: int) -> int:
    if pos == out.size:  # (max_length 0 would mean no limit)
        return pos
    got = z.decompress(data, out.size - pos)
    out[pos:pos + len(got)] = np.frombuffer(got, np.uint8)
    return pos + len(got)


def _check_predictor(lt: _Libtiff) -> None:
    """PredictorSetup, for the codecs that use the predictor (LZW,
    Deflate)."""
    if lt.compression not in _PREDICTED or lt.predictor == 1:
        return
    if lt.predictor == 2:
        if lt.bits not in (8, 16, 32):
            raise _bad(f"libtiff: horizontal differencing of {lt.bits}-bit "
                       "samples")
        return
    if lt.predictor == 3:
        if lt.sample_format != 3 or lt.bits not in (16, 24, 32, 64):
            raise _bad("libtiff: floating-point prediction of other than "
                       "16-, 24-, 32- or 64-bit floats")
        if lt.rowbytes % (lt.bits // 8 * (lt.spp if lt.planar == 1
                                          else 1)):
            raise _bad("libtiff: a row of a fractional float")
        return
    raise _bad(f"libtiff: predictor {lt.predictor} is not supported")


def _libtiff_tiles(data: bytes, ifd: Directory, lay: Layout) -> np.ndarray:
    """ImagingLibTiffDecode's strip and tile loops: each strip (or tile)
    read whole by libtiff into one buffer that every read reuses, its rows
    unpacked into the image; plane by plane in planar configuration 2."""
    lt = _Libtiff(ifd, lay)
    _check_predictor(lt)
    # the codecs' setupdecode, which TIFFFillStrip runs before any read
    if lt.compression in (2, 3, 4, 32771) and lt.bits != 1:
        raise _bad("libtiff: bits/sample must be 1 for Group 3/4")
    if lt.compression == 32809 and lt.bits != 4:
        raise _bad("libtiff: ThunderScan decodes only 4 bits a sample")
    if lt.compression == 6:
        lt.ojpeg = OldJpeg(data, lt, lt.ojpeg_tags)
        if lt.ojpeg.ycc:  # libtiff reports the JPEG's own sampling
            lt.ycbcr_sub = (lt.ojpeg.hor, lt.ojpeg.ver)
    if lt.photo == 6 and not (lt.compression == 7 and lt.planar == 1):
        return _rgba_image(data, ifd, lay, lt)
    mode, rawmode = lay.mode, lay.rawmode
    if rawmode not in _UNPACKERS.get(mode, ()):
        raise _bad(f"no Pillow unpacker for mode {mode} from {rawmode}")
    unpackers = [rawmode]
    # Pillow reads a plane a band; a one-band image reads as planar 1
    planes = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(mode, 1) \
        if lt.planar == 2 else 1
    if planes > 1:
        if lt.bits not in (8, 16):
            raise _bad("Pillow: planar TIFF of other than 8 or 16 bits")
        unpackers = [("R", "G", "B", "A")[p] + (";16N" if lt.bits == 16
                                                else "")
                     for p in range(planes)]
    bits = _RAW_BITS[rawmode] // planes
    img = _blank(mode, lay.ysize, lay.xsize)
    lib = native.library()
    jpeg = _JpegStrips(ifd, lt, lay) if lt.compression == 7 else None
    # _decodeTile and _decodeStrip refuse, before their buffer's realloc,
    # a tile side or RowsPerStrip that is no int, and a buffer of INT_MAX
    if lt.tiled:
        if max(lt.tw, lt.tl) > _INT_MAX:
            raise _bad("TIFF tiles too large (Pillow: decoder error -9)")
        seg_w, seg_h = lt.tw, lt.tl
        size = lt.rowbytes * lt.tl
    else:
        if _INT_MAX < lt.rps < 2 ** 32 - 1:
            raise _bad("a TIFF RowsPerStrip too large (Pillow: decoder "
                       "error -9)")
        seg_w = lt.width
        seg_h = min(lt.rps, lt.length)
        size = lt.rowbytes * seg_h
    if size > _INT_MAX - 1:
        raise _bad("a TIFF strip or tile of 2 GiB (Pillow: decoder error -9)")
    if (seg_w * bits + 7) // 8 != lt.rowbytes:
        raise _bad("Pillow: the rows libtiff gives are not the mode's rows")
    buf = np.zeros(size, np.uint8)
    per_plane = lt.n // (lt.spp if lt.planar == 2 else 1)
    across = -(-lt.width // seg_w)
    for y in range(0, lay.ysize, seg_h):
        rows = min(seg_h, lt.length - y)
        for plane in range(planes):
            for x in range(0, lay.xsize, seg_w):
                index = plane * per_plane + (y // seg_h) * across + x // seg_w
                n_rows = seg_h if lt.tiled else rows
                chunk = buf[:lt.rowbytes * n_rows]
                raw = lt.raw(data, index)
                if jpeg is not None:
                    jpeg.decode(raw, chunk, n_rows, y, plane)
                else:
                    _decode_chunk(lib, lt, raw, chunk, n_rows, seg_w)
                w = min(seg_w, lay.xsize - x)
                h = min(seg_h, lay.ysize - y)
                block = chunk.reshape(n_rows, lt.rowbytes)[:h]
                un = unpackers[plane]
                if planes > 1:
                    values = _plane_unpack(un, block, w)
                else:
                    values = _unpack(mode, un, block, w)
                _store(img, (x, y, x + w, y + h), values)
    if planes > 3 and mode == "RGBA":
        if lt.extra and lt.extra[0] in (0, 1):
            img = _unpremultiply(img)
    return img


# libtiff's YCbCr->RGB (tif_color.c TIFFYCbCrToRGBInit, TIFFYCbCrtoRGB)
_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)


def _fix(x) -> int:
    """FIX(x): (int32_t)(x * 65536 + 0.5), x a float, the sum a double."""
    return int(float(np.float32(x) * np.float32(65536.0)) + 0.5)


def _clampf(f, lo, hi):
    f = np.asarray(f, np.float32)
    return np.where(~(f >= lo), np.float32(lo), np.where(f > hi,
                                                         np.float32(hi), f))


def _ycbcr_tables(luma, ref_bw):
    """TIFFYCbCrToRGBInit's tables (Y, Cr->R, Cb->B, Cr->G, Cb->G), with
    libtiff's float32 arithmetic."""
    f32 = np.float32
    red, green, blue = (f32(v) for v in luma)
    f1 = f32(2) - f32(2) * red
    d1 = _fix(_clampf(f1, 0.0, 2.0))
    f2 = red * f1 / green
    d2 = -_fix(_clampf(f2, 0.0, 2.0))
    f3 = f32(2) - f32(2) * blue
    d3 = _fix(_clampf(f3, 0.0, 2.0))
    f4 = blue * f3 / green
    d4 = -_fix(_clampf(f4, 0.0, 2.0))
    x = np.arange(-128, 128, dtype=np.int32)

    def code2v(c, rb, rw, cr):
        rb, rw = f32(rb), f32(rw)
        den = rw - rb if rw - rb != 0 else f32(1)
        num = (c - np.int32(np.trunc(rb))).astype(np.float32) * f32(cr)
        return num / den

    def clamp32(f):
        return np.trunc(_clampf(f, -128.0 * 32, 128.0 * 32)).astype(np.int64)

    cr = clamp32(code2v(x, ref_bw[4] - f32(128), ref_bw[5] - f32(128), 127))
    cb = clamp32(code2v(x, ref_bw[2] - f32(128), ref_bw[3] - f32(128), 127))
    y = clamp32(code2v(x + 128, ref_bw[0], ref_bw[1], 255))
    return (y, (d1 * cr + _ONE_HALF) >> _SHIFT,
            (d3 * cb + _ONE_HALF) >> _SHIFT, d2 * cr, d4 * cb + _ONE_HALF)


def _rgba_image(data: bytes, ifd: Directory, lay: Layout,
                lt: "_Libtiff") -> np.ndarray:
    """Pillow's _decodeAsRGBA: a YCbCr image not JPEG-coded in one plane,
    read through libtiff's TIFFRGBAImage a strip or a row of tiles at a
    time (gtStripContig, gtTileContig: each sampling block a block of luma
    and one Cb, Cr pair, chroma replicated; gtStripSeparate,
    gtTileSeparate: the three planes, 1x1 only), converted by
    TIFFYCbCrtoRGB's tables and unpacked by Pillow's unpacker from RGBA.
    Pillow asks libtiff not to stop on errors: a chunk that fails to decode
    is read as the codec left its buffer (zeros where nothing was read
    before), though the first chunk of a call that libtiff cannot read
    fails the image. No row is turned, whatever the orientation tag."""
    hs, vs = lt.ycbcr_sub if lt.ycbcr_sub is not None else (2, 2)
    contig = lt.planar == 1
    # PickContigCase / PickSeparateCase switch on (hs << 4) | vs
    key = (hs << 4) | vs
    if lt.bits != 8 or lt.spp != 3 or key not in (
            (0x44, 0x42, 0x41, 0x22, 0x21, 0x12, 0x11) if contig else (0x11,)):
        raise _bad("libtiff's RGBA reader cannot handle this YCbCr format")
    if contig and not (hs in (1, 2, 4) and vs in (1, 2, 4)):
        raise _bad("libtiff: invalid YCbCr subsampling")
    if not contig:
        hs = vs = 1
    if lt.predictor != 1 and (hs, vs) != (1, 1):
        raise _unsupported("a predictor on subsampled YCbCr")
    luma = lt.luma if lt.luma is not None else np.array(
        [0.299, 0.587, 0.114], np.float32)
    ref_bw = lt.ref_bw if lt.ref_bw is not None else np.array(
        [0, 255, 128, 255, 128, 255], np.float32)
    if np.isnan(luma).any() or abs(float(luma[1])) < 1e-10 or not np.all(
            (ref_bw > -(2 ** 31)) & (ref_bw < 2 ** 31)):
        raise _bad("libtiff: invalid YCbCrCoefficients or "
                   "ReferenceBlackWhite")
    tables = _ycbcr_tables(luma, ref_bw)
    width, height = lay.xsize, lay.ysize
    if lt.tiled:
        seg_w, seg_h = lt.tw, lt.tl
        block = lt.tl
    else:
        seg_w = width
        seg_h = height if lt.rps == 2 ** 32 - 1 else min(lt.rps, height)
        block = height if lt.rps == 2 ** 32 - 1 else lt.rps
    # _decodeAsRGBA's check before it reallocs a block of RGBA rows, and
    # gtTileContig's and gtTileSeparate's "unsupported tile size"
    if _INT_MAX // (width * 4) < block:
        raise _bad("TIFF blocks of RGBA rows too large (Pillow: decoder "
                   "error -9)")
    if lt.tiled and lt.tw > _INT_MAX + width:
        raise _bad("libtiff: unsupported tile size (too wide)")
    per_block = hs * vs + 2
    row_size = -(-seg_w // hs) * per_block  # a sampling row's bytes
    full = -(-seg_h // vs) * row_size if contig else seg_h * seg_w
    alloc = full if contig else 3 * full  # TIFFTileSize (a plane's), read
    lt.rowbytes = row_size // vs if contig else seg_w  # the predictor's row
    jpeg = _JpegStrips(ifd, lt, lay) if lt.compression == 7 else None
    lib = native.library()
    per_plane = lt.n // (1 if contig else 3)
    across = -(-width // seg_w)
    img = _blank(lay.mode, height, width)
    if lt.compression == 6 and lt.ojpeg.dry_line is None:
        # old-style JPEG that libjpeg reads to the end: every strip's
        # sampling blocks at once (the conversion is block by block)
        blocks = np.zeros((1, -(-height // vs) * row_size), np.uint8)
        lt.ojpeg.strip(0, blocks[0], height, whole=True)
        rgba = np.full((height, width, 4), 255, np.uint8)
        rgba[..., :3] = _ycbcr_block(blocks, tables, height, width, width,
                                     hs, vs, True)
        _store(img, (0, 0, width, height),
               _unpack(lay.mode, lay.rawmode, rgba.reshape(height, -1),
                       width))
        return img
    for y in range(0, height, seg_h):
        rows = min(seg_h, height - y)
        chunk_rows = seg_h if lt.tiled else min(seg_h, lt.length - y)
        if contig:
            size = -(-chunk_rows // vs) * row_size
            if not lt.tiled:
                size = min(-(-rows // vs) * vs * lt.rowbytes, size)
        else:
            size = chunk_rows * seg_w
        buf = None  # a call's buffer, allocated at its first read
        for x in range(0, width, seg_w):
            w = min(seg_w, width - x)
            for plane in range(1 if contig else 3):
                index = plane * per_plane + (y // seg_h) * across + x // seg_w
                try:
                    raw = lt.raw(data, index)
                    if lt.compression == 6 and lt.ojpeg.unreadable(index):
                        # OJPEGPreDecode cannot skip the rows before it
                        raise _bad("libtiff: old-style JPEG data ends before "
                                   "this strip")
                    if buf is None and lt.tiled and alloc > 100_000_000 \
                            and len(raw) < full // 1000:
                        # _TIFFReadEncodedTileAndAllocBuffer's guard
                        # against a bomb, before it allocates
                        raise _bad("libtiff: likely invalid tile byte "
                                   "count")
                    if jpeg is not None:  # JPEG fails in TIFFFillStrip
                        out = np.zeros(size, np.uint8)
                        jpeg.decode(raw, out, chunk_rows, y, plane)
                except BadRequest:
                    if buf is None:
                        raise
                    buf[plane, :size] = 0  # TIFFReadEncodedStrip/Tile
                    continue
                if buf is None:
                    buf = np.zeros((1 if contig else 3, full), np.uint8)
                if jpeg is not None:
                    buf[plane, :size] = out
                else:
                    _decode_chunk(lib, lt, raw, buf[plane, :size],
                                  chunk_rows, seg_w, strict=False)
            rgb = _ycbcr_block(buf, tables, rows, w, seg_w, hs, vs, contig)
            rgba = np.full((rows, w, 4), 255, np.uint8)
            rgba[..., :3] = rgb
            rows_bytes = np.ascontiguousarray(rgba).reshape(rows, w * 4)
            _store(img, (x, y, x + w, y + rows),
                   _unpack(lay.mode, lay.rawmode, rows_bytes, w))
    return img


def _ycbcr_block(buf, tables, rows, width, seg_w, hs, vs, contig):
    """TIFFYCbCrtoRGB over the first `rows` x `width` pixels of a chunk
    (C++): contiguous sampling blocks (ceil(seg_w / hs) a block row) or
    three planes of seg_w samples a row, which are 1 x 1 blocks."""
    if contig:
        across = -(-seg_w // hs)
        blocks = buf[0, :-(-rows // vs) * across * (hs * vs + 2)]
    else:
        blocks = np.stack([buf[p, :rows * seg_w] for p in range(3)], axis=1)
        across, hs, vs = seg_w, 1, 1
    blocks = np.ascontiguousarray(blocks)
    rgb = np.empty((rows, width, 3), np.uint8)
    lut = [np.ascontiguousarray(t, np.int64) for t in tables]
    native.library().ecgmm_ycbcr_blocks(
        blocks.ctypes.data, rows, width, across, hs, vs,
        *(t.ctypes.data for t in lut), rgb.ctypes.data)
    return rgb


def _plane_unpack(unpacker, block, width):
    """Pillow's plane unpackers ("R", "G", "B", "A", 8- or 16-bit in host
    order) into the bytes of a four-byte pixel."""
    band = "RGBA".index(unpacker[0])
    if unpacker.endswith(";16N"):
        v = (block[:, :2 * width].copy().view("<u2") >> 8).astype(np.uint8)
    else:
        v = block[:, :width]
    return band, v


class _JpegStrips:
    """JPEG-in-TIFF (compression 7) as tif_jpeg.c reads it: the
    JPEGTables tag's tables loaded first, then each strip or tile a JPEG
    image of its own whose end libtiff pads with EOI markers; its size,
    component count and sampling checked against the directory; YCbCr in
    one plane converted to RGB (`JPEGCOLORMODE_RGB`, which Pillow sets),
    every other colour space passed through as coded."""

    def __init__(self, ifd: Directory, lt: _Libtiff, lay: Layout):
        self.lt, self.lay = lt, lay
        if lt.bits != 8:
            raise _unsupported(f"{lt.bits}-bit JPEG-in-TIFF")
        # libjpeg's decompressor is libtiff's for the whole image: the
        # tables of JPEGTables, then of each strip read, stand for the next
        self.tables = imdecode.jpeg_tables()
        if lt.jpeg_tables is not None:
            _jpeg_tables(lt.jpeg_tables, self.tables)
        self.ycc = lt.photo == 6 and lt.planar == 1
        self.sampling = (1, 1)
        if self.ycc:
            if lt.ycbcr_sub is not None:
                self.sampling = lt.ycbcr_sub
            else:  # JPEGFixupTagsSubsampling: the first strip's SOF
                self.sampling = _first_sampling(ifd, lt) or (2, 2)

    def decode(self, raw: bytes, out: np.ndarray, rows: int, y: int,
               plane: int) -> None:
        lt = self.lt
        if lt.tiled:
            seg_w, seg_h = lt.tw, lt.tl
        else:
            seg_w, seg_h = lt.width, rows
        if lt.planar == 2 and plane > 0:
            seg_w = -(-seg_w // self.sampling[0])
            seg_h = -(-seg_h // self.sampling[1])
        last_strip = not lt.tiled and y + rows == lt.length
        want = lt.spp if lt.planar == 1 else 1

        def check(frame):
            height, width, comps = frame
            if width > seg_w or height > seg_h:
                if not (width == seg_w and height > seg_h and last_strip):
                    raise _bad("libtiff: a JPEG strip larger than its TIFF "
                               "strip")
            if len(comps) != want:
                raise _bad("libtiff: improper JPEG component count")
            if lt.planar == 1:
                if (comps[0][1], comps[0][2]) != tuple(self.sampling):
                    raise _bad("libtiff: improper JPEG sampling factors")
                if any((c[1], c[2]) != (1, 1) for c in comps[1:]):
                    raise _bad("libtiff: improper JPEG sampling factors")
            elif (comps[0][1], comps[0][2]) != (1, 1):
                raise _bad("libtiff: improper JPEG sampling factors")

        if raw[:2] != b"\xff\xd8":
            raise _bad("libtiff: a JPEG strip that is not a JPEG image")
        samples = imdecode._decode_jpeg(
            raw + b"\xff\xd9", imdecode.InTiff("ycc" if self.ycc else "raw",
                                               check, self.tables))
        height, width = samples.shape[:2]
        n = min(rows, height)
        block = out.reshape(rows, lt.rowbytes)
        block[:n, :samples[:n].size // max(n, 1)] = samples[:n].reshape(n, -1)


def _jpeg_tables(tables: bytes, state) -> None:
    """A JPEGTables datastream's DQT and DHT tables into `state`
    (`imdecode.jpeg_tables()`), read as libjpeg reads tables only
    (jpeg_read_header(FALSE), its source padding the end with EOI
    markers): a frame or scan header, a second SOI, an unknown marker or
    a bad table is "Bogus JPEGTables"."""
    if tables[:2] != b"\xff\xd8":
        raise _bad("libtiff: bogus JPEGTables field (no SOI)")
    padded = tables + b"\xff\xd9" * 2
    qtables, huff_bits, huff_vals, defined = state
    pos, n = 2, len(tables)
    while True:
        while pos < n and tables[pos] != 0xFF:
            pos += 1
        while pos < n and tables[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break  # the padding's EOI
        marker = tables[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x00, 0x01):
            continue
        if marker in imdecode._JPEG_UNKNOWN or marker == 0xDA or (
                0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xCC)):
            raise _bad("libtiff: bogus JPEGTables field")
        if pos + 2 > len(padded) - 2:
            padded += b"\xff\xd9"
        (length,) = struct.unpack(">H", padded[pos:pos + 2])
        if pos + length > len(padded):
            padded += b"\xff\xd9" * ((pos + length - len(padded)) // 2 + 1)
        seg = padded[pos + 2:pos + length]
        if length < 2:
            raise _bad("libtiff: bogus JPEGTables field (bad length)")
        if marker == 0xDB:
            imdecode._parse_dqt(seg, qtables)
        elif marker == 0xC4:
            imdecode._parse_dht(seg, huff_bits, huff_vals, defined)
        elif marker == 0xCC:
            imdecode._parse_dac(seg, np.zeros((3, 16), np.uint8))
        elif marker == 0xDD and length != 4:
            raise _bad("libtiff: bogus JPEGTables field (DRI)")
        pos += length
        if pos >= n:
            break  # past the field: the padding's EOI ends the tables


def _first_sampling(ifd: Directory, lt: _Libtiff):
    """JPEGFixupTagsSubsampling: the first component's sampling factors in
    the first strip's frame header (SOF0, 1, 2, 9 or 10), where they are
    1, 2 or 4 and the other components' are 1x1; None where the walk
    over the markers finds none."""
    if not lt.counts or not lt.counts[0]:
        return None
    raw = ifd.data[lt.offsets[0]:lt.offsets[0] + lt.counts[0]]
    if raw[:2] != b"\xff\xd8":
        return None
    pos = 2
    skipped = {0xC4, 0xDB, 0xDD, 0xFE} | set(range(0xE0, 0xF0))
    while pos + 4 <= len(raw):
        if raw[pos] != 0xFF:
            return None
        while pos + 1 < len(raw) and raw[pos + 1] == 0xFF:
            pos += 1
        marker = raw[pos + 1]
        if pos + 4 > len(raw):
            return None
        (length,) = struct.unpack(">H", raw[pos + 2:pos + 4])
        if marker in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            seg = raw[pos + 4:pos + 2 + length]
            if len(seg) < 15 or seg[5] != 3:
                return None
            hv = seg[7]
            h, v = hv >> 4, hv & 15
            if h not in (1, 2, 4) or v not in (1, 2, 4):
                return None
            if seg[10] != 0x11 or seg[13] != 0x11:
                return None
            return h, v
        if marker not in skipped:
            return None
        pos += 2 + length
    return None


# ------------------------------------------------------------ entry


def decode_tiff(data: bytes):
    """(RGB as stored, orientation, XMP packet): the first page as Pillow
    loads it; the IFD's orientation tag as Pillow holds it (None where
    there is none), which `load_end` applies, and, where there is none,
    the XMP packet whose `tiff:Orientation` it applies instead."""
    try:  # TiffImageFile._open: Image.open steps past what fails here
        ifd = Directory(data)
        lay = _setup(ifd)
    except imdecode.STEPPED_PAST as e:
        raise imdecode.Decline(f"TIFF: {e}") from None
    if lay.xsize <= 0 or lay.ysize <= 0:
        raise _bad("a TIFF of no pixels")
    _check_pixels(lay.xsize, lay.ysize)
    if lay.compression not in _DECODED:
        raise _unsupported(
            f"TIFF compression {lay.compression} "
            f"({_COMPRESSION_NAMES[lay.compression]})")
    if lay.libtiff:
        img = _libtiff_tiles(data, ifd, lay)
    else:
        img = _raw_tiles(data, lay)
    rgb = imdecode._mode_to_rgb(lay.mode, img, lay.palette)
    orientation = lay.orientation if ORIENTATION in ifd else None
    xmp = None
    if orientation is None and XMP in ifd:
        xmp = ifd.value(XMP)
        if isinstance(xmp, tuple) and len(xmp) == 1:
            xmp = xmp[0]
    return rgb, orientation, xmp
