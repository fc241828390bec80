"""The small upload formats and the order uploads are identified in.

`PLUGINS` is Pillow 12's `Image.ID` as it stands once `Image.open` has
loaded every plugin: `Image.open` offers the first 16 bytes to each
plugin's `_accept` in that order (a plugin without one is always tried),
opens the file with the first that accepts it, and goes on to the next
where the plugin's `_open` raises SyntaxError or one of the errors
`ImageFile` turns into it (IndexError, TypeError, KeyError, EOFError,
struct.error) or leaves no mode or no pixels. Any other error ends the
open. The port follows the same order: each entry decodes (the port's
formats) or refuses as unsupported, naming the format (the others); an
entry that cannot tell as exactly as Pillow whether its plugin would take
the file refuses it, so bytes Pillow reads with one plugin are never
decoded as another's.

The plugins without `_accept` (IM, IMT, IPTC, PCD, SPIDER, TGA) are
recognised by the header checks their `_open` makes before it commits;
TGA, which checks little, is reached only after all of them.

Decoded here, as Pillow's plugins read them and `.convert("RGB")`
converts them:

- DIB (`BmpImagePlugin.DibImageFile`): a BMP without its file header,
  through the same reading of the bitmap header as BMP (`bitmap`,
  Pillow's `_bitmap`): the grey palettes Pillow drops, the rows its raw
  decoder asks for, RLE8 and RLE4 by its run decoder;
- CUR (`CurImagePlugin`): the cursor Pillow picks, its bitmap at half
  height;
- ICO (`IcoImagePlugin`): the entry Pillow loads (the largest, then the
  fewest colours), PNG through `imdecode._decode_png`, BMP at half height
  with the AND mask or the 32-bit alpha read as Pillow reads it;
- PSD (`PsdImagePlugin`): the composite image, raw or PackBits a channel
  (Pillow's own PackBits, `native/rasters.cpp`), modes 1, L (grey,
  duotone, multichannel), P, RGB, RGBA and CMYK; CIELAB is refused as
  unsupported;
- QOI (`QoiImagePlugin`): every op, with the plugin's quirks (an index
  never filled reads transparent black; a run stores no index);
- TGA (`TgaImagePlugin`): image types 1, 2, 3 and their run-length forms
  9, 10, 11 at 1, 8, 16, 24 and 32 bits, colour maps of 16 or 24 bits
  with their first index, the id field, both flips.
"""

from __future__ import annotations

import io
import math
import re
import struct
from typing import Optional

import numpy as np

from ecgmm_torch import native
from ecgmm_torch.serve import imdecode, jpeg2000
from ecgmm_torch.serve.imdecode import (STEPPED_PAST, Decline, _bad,
                                        _check_pixels, _mode_to_rgb,
                                        _unsupported)


def _u16(b: bytes, o: int = 0, end: str = "<") -> int:
    return struct.unpack_from(end + "H", b, o)[0]


def _u32(b: bytes, o: int = 0, end: str = "<") -> int:
    return struct.unpack_from(end + "I", b, o)[0]


def _safe_read(f: io.BytesIO, size: int) -> bytes:
    """ImageFile._safe_read: `size` bytes, or OSError (an error that ends
    the open) where the file holds fewer."""
    if size <= 0:
        return b""
    data = f.read(size)
    if len(data) < size:
        raise _bad("truncated header (Pillow: Truncated File Read)")
    return data


def _opened(mode: str, size) -> None:
    """ImageFile.__init__'s check after `_open`: a mode and pixels."""
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise Decline("no mode or no pixels")


# ---------------------------------------------------------------- rows

# Pillow's raw unpackers: rawmode -> bits a pixel
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "LA": 16,
             "BGR;15": 16, "BGR;16": 16, "BGRA;15Z": 16, "BGR": 24,
             "BGRX": 32, "BGRA": 32, "XBGR": 32, "BGXR": 32, "ABGR": 32,
             "RGBA": 32, "BGAR": 32}
# the R, G, B byte of a pixel of the 3- and 4-byte rawmodes
_RGB_AT = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "BGRA": (2, 1, 0),
           "XBGR": (3, 2, 1), "BGXR": (3, 1, 0), "ABGR": (3, 2, 1),
           "RGBA": (0, 1, 2), "BGAR": (3, 1, 0)}


def _raw_rows(data: bytes, offset: int, width: int, height: int,
              rawmode: str, stride: int = 0, bottom_up: bool = False):
    """Pillow's raw decoder: `height` rows of the rawmode's bytes from
    `offset`, `stride` apart (0: packed), the last row's padding not
    needed; the rows in image order."""
    row = (width * _RAW_BITS[rawmode] + 7) // 8
    stride = stride or row
    if stride < row:
        raise _bad("rows longer than their stride (Pillow: decoder error "
                   "-8)")
    if offset < 0:
        raise _bad("a negative pixel data offset")
    if offset + stride * (height - 1) + row > len(data):
        raise _bad("truncated pixel data (Pillow: image file is "
                   "truncated)")
    buf = np.frombuffer(data, np.uint8, stride * (height - 1) + row, offset)
    rows = np.lib.stride_tricks.as_strided(buf, (height, row), (stride, 1))
    return rows[::-1] if bottom_up else rows


def _unpack(rawmode: str, rows: np.ndarray, width: int) -> np.ndarray:
    """Pillow's unpacker of `rawmode` over (height, bytes) rows: indices or
    grey (one band) or RGB."""
    bits = _RAW_BITS[rawmode]
    if bits == 1:
        v = np.unpackbits(rows, axis=1)[:, :width]
        return v * np.uint8(255) if rawmode == "1" else v
    if bits == 4:
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(
            len(rows), -1)[:, :width]
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode == "LA":
        return rows[:, :2 * width:2]
    if bits == 16:
        px = rows[:, :2 * width].copy().view("<u2").astype(np.uint32)
        fields = ((11, 31), (5, 63), (0, 31)) if rawmode == "BGR;16" else \
            ((10, 31), (5, 31), (0, 31))
        return np.stack([((px >> s) & m) * 255 // m for s, m in fields],
                        axis=2).astype(np.uint8)
    k = bits // 8
    px = rows[:, :k * width].reshape(len(rows), width, k)
    return np.ascontiguousarray(px[..., list(_RGB_AT[rawmode])])


def _palette(raw: bytes, entry: int, rgb_at, start: int = 0):
    """A palette of `entry`-byte entries as Pillow puts it on the image
    (256 x 3, black past the file's); more than 256 entries is refused
    ("invalid palette size")."""
    n = len(raw) // entry
    if entry * start + len(raw) > 256 * entry:
        raise _bad("a palette of more than 256 colours (Pillow: invalid "
                   "palette size)")
    table = np.zeros((256, 3), np.uint8)
    if n:
        table[start:start + n] = np.frombuffer(
            raw, np.uint8, n * entry).reshape(n, entry)[:, list(rgb_at)]
    return table


def _check(status: int, what: str) -> None:
    if status == -40:
        raise _bad(f"{what} (Pillow: buffer overrun when reading image "
                   "file)")
    if status == -41:
        raise _bad(f"{what} (Pillow: image file is truncated)")
    if status:
        raise _bad(f"{what} (decoder error {status})")


# ---------------------------------------------------------------- BMP

_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


class Bitmap:
    """What BmpImageFile._bitmap leaves: the mode, the rawmode, the
    palette, the size and the tile."""

    mode: str
    rawmode: str
    palette: Optional[bytes]
    entry: int
    width: int
    height: int
    offset: int
    rle: Optional[bool]  # None: raw rows; else RLE4 (True) or RLE8
    stride: int
    bottom_up: bool


def bitmap(f: io.BytesIO, header: int = 0, offset: int = 0) -> Bitmap:
    """BmpImageFile._bitmap from the file position (or `header`): the
    bitmap header, the BI_BITFIELDS masks, the palette; errors that end
    the open as BadRequest, those Image.open steps past as Decline (the
    caller's `STEPPED_PAST`)."""
    if header:
        f.seek(header)
    hsize = _u32(f.read(4))
    hdata = _safe_read(f, hsize - 4)
    bm = Bitmap()
    colors = 0
    masks = None
    bm.bottom_up = True
    if hsize == 12:
        bm.width, bm.height, _, bits = (_u16(hdata, o) for o in (0, 2, 4, 6))
        compression, padding = 0, 3
    elif hsize in _BMP_HEADERS[1:]:
        y_flip = hdata[7] == 0xFF
        bm.bottom_up = not y_flip
        bm.width = _u32(hdata, 0)
        bm.height = _u32(hdata, 4) if not y_flip else 2 ** 32 - _u32(hdata, 4)
        bits = _u16(hdata, 10)
        compression = _u32(hdata, 12)
        colors = _u32(hdata, 28)
        padding = 4
        if compression == 3:
            if len(hdata) >= 48:
                n = 4 if len(hdata) >= 52 else 3
                masks = tuple(_u32(hdata, 36 + 4 * i) for i in range(n))
            else:
                masks = tuple(_u32(f.read(4)) for _ in range(3))
            if len(masks) == 3:
                masks += (0,)
    else:
        raise _unsupported(f"BMP with a {hsize}-byte header (Pillow: "
                           "Unsupported BMP header type)")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise _unsupported(f"{bits}-bit BMP")
    bm.mode, bm.rawmode = _BIT2MODE[bits]
    bm.rle = None
    if compression == 3:
        key = masks if bits == 32 else masks[:3]
        if (bits, key) not in _MASK_MODES:
            raise _unsupported("BMP bitfields layout "
                               f"{tuple(hex(m) for m in masks)}")
        bm.rawmode = _MASK_MODES[(bits, key)]
    elif compression in (1, 2):
        bm.rle = compression == 2
    elif compression != 0:
        raise _unsupported(f"BMP with compression {compression}")
    bm.palette, bm.entry = None, padding
    if bm.mode == "P":
        if not 0 < colors <= 65536:
            raise _bad(f"BMP palette of {colors} colours")
        palette = f.read(padding * colors)
        indices = (0, 255) if colors == 2 else range(colors)
        # (o8 keeps an index's low byte)
        grey = all(palette[i * padding:i * padding + 3] == bytes([v & 255])
                   * 3 for i, v in enumerate(indices))
        if grey:
            bm.mode = bm.rawmode = "1" if colors == 2 else "L"
        else:
            bm.palette = palette
    bm.stride = ((bm.width * bits + 31) >> 3) & ~3
    bm.offset = offset or f.tell()
    return bm


def load_bitmap(data: bytes, bm: Bitmap, height: Optional[int] = None
                ) -> np.ndarray:
    """The bitmap's pixels as RGB (`height`: its first rows in image order,
    as an icon's half-height tile reads them)."""
    width = bm.width
    height = bm.height if height is None else height
    if bm.rle is not None:
        pixels = _bmp_rle(data, bm, width, height)
        if bm.mode not in ("L", "P"):
            # set_as_raw puts "P" (or "L") samples on the image
            raise _bad(f"a BMP with compression {2 if bm.rle else 1} in mode "
                       f"{bm.mode} (Pillow: unknown raw mode)")
    else:
        rows = _raw_rows(data, bm.offset, width, height, bm.rawmode,
                         bm.stride, bm.bottom_up)
        pixels = _unpack(bm.rawmode, rows, width)
        if pixels.ndim == 3:
            return pixels
    if bm.palette is not None:
        table = _palette(bm.palette, bm.entry, (2, 1, 0))
        return table[pixels]
    return _mode_to_rgb("L", pixels)


def _bmp_rle(data: bytes, bm: Bitmap, width: int, height: int):
    """BmpRleDecoder's indices (the run decoding in C++), `height` rows in
    image order; fewer than the image needs is refused ("not enough image
    data")."""
    out = np.zeros(width * height, np.uint8)
    written = np.zeros(1, np.int64)
    body = data[bm.offset:]
    status = native.library().ecgmm_bmp_rle(
        body, len(body), bm.offset, int(bm.rle), width, out.ctypes.data,
        out.size, written.ctypes.data)
    kind = f"BMP RLE data (compression {2 if bm.rle else 1})"
    if status:
        raise _bad(f"{kind}: a truncated delta")
    if written[0] < out.size:
        raise _bad(f"{kind} ends before the last pixel (Pillow: not enough "
                   "image data)")
    index = out.reshape(height, width)
    return index[::-1] if bm.bottom_up else index


def _open_bitmap(f: io.BytesIO, header: int = 0, offset: int = 0) -> Bitmap:
    try:
        bm = bitmap(f, header, offset)
    except STEPPED_PAST as e:
        raise Decline(f"BMP: {e}") from None
    _opened(bm.mode, (bm.width, bm.height))
    return bm


def decode_bmp(data: bytes) -> np.ndarray:
    """BmpImageFile: the file header, then the bitmap at its offset."""
    f = io.BytesIO(data)
    head = f.read(14)
    try:
        offset = _u32(head, 10)
    except struct.error:
        raise Decline("BMP: truncated file header") from None
    bm = _open_bitmap(f, offset=offset)
    _check_pixels(bm.width, bm.height)
    return load_bitmap(data, bm)


def decode_dib(data: bytes) -> np.ndarray:
    """DibImageFile: the bitmap header at the start of the file."""
    bm = _open_bitmap(io.BytesIO(data))
    _check_pixels(bm.width, bm.height)
    return load_bitmap(data, bm)


# ---------------------------------------------------------------- CUR, ICO


def decode_cur(data: bytes) -> np.ndarray:
    """CurImageFile: the first entry unless a later one is larger in both
    sides, its bitmap (found by the entry's offset; an offset of 0 reads
    on from the directory) at half height."""
    f = io.BytesIO(data)
    s = f.read(6)
    try:
        m = b""
        for _ in range(_u16(s, 4)):
            s = f.read(16)
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
        if not m:
            raise Decline("CUR: no cursors")
        at = _u32(m, 12)
    except STEPPED_PAST as e:
        raise Decline(f"CUR: {e}") from None
    bm = _open_bitmap(f, header=at)
    height = bm.height // 2
    _opened(bm.mode, (bm.width, height))
    _check_pixels(bm.width, height)
    return load_bitmap(data, bm, height)


class _IconEntry:
    def __init__(self, s: bytes):
        self.width = s[0] or 256
        self.height = s[1] or 256
        nb_color = s[2]
        self.bpp = _u16(s, 6)
        self.size = _u32(s, 8)
        self.offset = _u32(s, 12)
        self.square = self.width * self.height
        self.color_depth = self.bpp or (
            nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256


def decode_ico(data: bytes) -> np.ndarray:
    """IcoImageFile, the one plugin that loads its image inside `_open`:
    what fails anywhere in the load as Pillow steps past makes Image.open
    try the next plugin."""
    try:
        return _load_ico(data)
    except STEPPED_PAST as e:
        raise Decline(f"ICO: {e}") from None


def _load_ico(data: bytes) -> np.ndarray:
    """The entries sorted by colour depth, then by area, largest first;
    the first one's frame, a PNG or a BMP whose height is halved, its AND
    mask (or, at 32 bits, its alpha bytes) read as Pillow reads it."""
    f = io.BytesIO(data)
    s = f.read(6)
    entries = [_IconEntry(f.read(16)) for _ in range(_u16(s, 4))]
    entries.sort(key=lambda e: e.color_depth)
    entries.sort(key=lambda e: e.square, reverse=True)
    entry = entries[0]
    f.seek(entry.offset)
    if f.read(8) == imdecode.PNG_SIGNATURE:
        rgb, _, _ = imdecode._decode_png(data[entry.offset:])
        return rgb
    f.seek(entry.offset)
    bm = _open_bitmap(f)
    _check_pixels(bm.width, bm.height)
    width, height = bm.width, int(bm.height / 2)
    if entry.bpp == 32:
        f.seek(bm.offset)
        if len(f.read(width * height * 4)) // 4 < width * height:
            raise _bad("an icon's alpha bytes end early (Pillow: not enough "
                       "image data)")
    else:
        w = width + (32 - width % 32 if width % 32 else 0)
        total = int((w * height) / 8)
        at = entry.offset + entry.size - total
        if at < 0:
            raise _bad("an icon's AND mask before the file (Pillow: negative "
                       "seek value)")
        f.seek(at)
        got = len(f.read(total))
        if height and got < int(w / 8) * (height - 1) + (width + 7) // 8:
            raise _bad("an icon's AND mask ends early (Pillow: not enough "
                       "image data)")
    if height <= 0:
        return np.zeros((0, width, 3), np.uint8)
    return load_bitmap(data, bm, height)


# ---------------------------------------------------------------- TGA

_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
            (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def decode_tga(data: bytes) -> np.ndarray:
    """TgaImageFile: the header's checks (any failing one steps past), the
    id field, the colour map from its first index (16-bit entries 5-5-5,
    24-bit BGR; 32-bit ones Pillow cannot put on the image; more than 256
    it refuses; a map on other than a grey or palette image it refuses; a
    grey image converts through its map),
    then the rows, raw or run-length coded (C++), bottom-up unless the
    descriptor says top-down, turned left to right where it says so."""
    f = io.BytesIO(data)
    s = f.read(18)
    try:
        id_len, cmap_type, image_type = s[0], s[1], s[2]
        depth, flags = s[16], s[17]
        width, height = _u16(s, 12), _u16(s, 14)
    except STEPPED_PAST as e:
        raise Decline(f"TGA: {e}") from None
    if cmap_type not in (0, 1) or width <= 0 or height <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise Decline("not a TGA file")
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise Decline("unknown TGA mode")
    orientation = flags & 0x30
    flip = orientation in (0x10, 0x30)
    top_down = orientation in (0x20, 0x30)
    f.read(id_len)
    palette = None
    if cmap_type:
        start, size, map_depth = _u16(s, 3), _u16(s, 5), s[7]
        if map_depth not in (16, 24, 32):
            raise Decline("unknown TGA map depth")
        k = map_depth // 8
        palette = (map_depth, start, f.read(k * size))
    offset = f.tell()
    _check_pixels(width, height)
    rawmode = _TGA_RAW.get((image_type & 7, depth))
    if rawmode is None:
        raise _bad(f"TGA type {image_type} at {depth} bits (Pillow: cannot "
                   "load this image)")
    table = None
    if palette is not None:
        map_depth, start, raw = palette
        if mode not in ("L", "LA", "P"):
            raise _bad("a TGA colour map on a colour image (Pillow: "
                       "unrecognized image mode)")
        if map_depth == 32:
            raise _bad("a 32-bit TGA colour map (Pillow: unrecognized raw "
                       "mode)")
        if map_depth == 16:
            px = np.frombuffer(raw, "<u2", len(raw) // 2).astype(np.uint32)
            rgb = np.stack([((px >> s) & 31) * 255 // 31
                            for s in (10, 5, 0)], axis=1).astype(np.uint8)
            table = _palette(rgb.tobytes(), 3, (0, 1, 2), start)
        else:
            table = _palette(raw, 3, (2, 1, 0), start)
    if mode == "L" and rawmode == "P":
        raise _bad("a TGA colour-mapped image without a colour map (Pillow: "
                   "unknown raw mode for given image mode)")
    if image_type & 8:
        rows = _tga_rle(data, offset, width, height, rawmode, depth)
        if not top_down:
            rows = rows[::-1]
    else:
        rows = _raw_rows(data, offset, width, height, rawmode,
                         bottom_up=not top_down)
    pixels = _unpack(rawmode, rows, width)
    if flip:
        pixels = pixels[:, ::-1]
    if table is not None:  # a grey image converts through its map too
        return table[pixels]
    if pixels.ndim == 3:
        return np.ascontiguousarray(pixels)
    return _mode_to_rgb("L", pixels)


def _tga_rle(data: bytes, offset: int, width: int, height: int,
             rawmode: str, depth: int) -> np.ndarray:
    """TgaRleDecode's rows, in the order it decodes them."""
    row = (width * _RAW_BITS[rawmode] + 7) // 8
    out = np.zeros((height, row), np.uint8)
    body = data[offset:]
    _check(native.library().ecgmm_tga_rle(body, len(body), depth // 8, row,
                                          height, out.ctypes.data),
           "bad or truncated TGA run-length data")
    return out


# ---------------------------------------------------------------- PSD

# (colour mode, bits) -> (Pillow mode, channels it reads)
_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def decode_psd(data: bytes) -> np.ndarray:
    """PsdImageFile: the header, the colour mode data (a 768-byte palette
    for mode P), the image resources and the layer section walked as the
    plugin walks them, then the composite image: each channel a tile of
    its own, raw or PackBits (the row byte counts read first)."""
    f = io.BytesIO(data)
    s = f.read(26)
    try:
        if s[:4] != b"8BPS" or _u16(s, 4, ">") != 1:
            raise Decline("not a PSD file")
        bits, channels_in, psd_mode = (_u16(s, o, ">") for o in (22, 12, 24))
        mode, channels = _PSD_MODES[(psd_mode, bits)]
    except STEPPED_PAST as e:
        raise Decline(f"PSD: {e}") from None
    if channels > channels_in:
        raise _bad("a PSD of too few channels (Pillow: not enough channels)")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    width, height = _u32(s, 18, ">"), _u32(s, 14, ">")
    try:
        palette = _psd_sections(f, mode)
        compression, offsets = _psd_tiles(f, channels, width, height)
    except STEPPED_PAST as e:
        raise Decline(f"PSD: {e}") from None
    _opened(mode, (width, height))
    _check_pixels(width, height)
    if mode == "LAB":
        raise _unsupported("CIELAB PSD")
    if compression not in (0, 1):
        raise _bad(f"PSD compression {compression} (Pillow: cannot load this "
                   "image)")
    row = (width + 7) // 8 if mode == "1" else width
    planes = []
    lib = native.library()
    for c in range(channels):
        if compression == 0:
            rows = _raw_rows(data, offsets[c], width, height,
                             "1" if mode == "1" else "L")
        else:
            rows = np.zeros((height, row), np.uint8)
            body = data[offsets[c]:]
            used = np.zeros(1, np.int64)
            _check(lib.ecgmm_pil_packbits(body, len(body), row, height,
                                          rows.ctypes.data, used.ctypes.data),
                   "bad or truncated PSD PackBits channel")
        planes.append(rows)
    if mode == "1":
        return _mode_to_rgb("1", _unpack("1", planes[0], width))
    if mode == "L":
        return _mode_to_rgb("L", planes[0][:, :width])
    if mode == "P":
        if palette is None:
            return np.zeros((height, width, 3), np.uint8)
        table = np.frombuffer(palette, np.uint8).reshape(3, 256).T
        return table[planes[0][:, :width]]
    px = np.stack([p[:, :width] for p in planes], axis=2)
    if mode == "CMYK":
        return _mode_to_rgb("CMYK", 255 - px)
    return np.ascontiguousarray(px[..., :3])


def _psd_sections(f: io.BytesIO, mode: str) -> Optional[bytes]:
    """The colour mode data, image resources and layer and mask section,
    read as PsdImageFile._open reads them (a short read there raises what
    Image.open steps past); the palette where there is one."""
    palette = None
    size = _u32(f.read(4), 0, ">")
    if size:
        block = f.read(size)
        if mode == "P" and size == 768:
            palette = block
    size = _u32(f.read(4), 0, ">")
    if size:
        end = f.tell() + size
        while f.tell() < end:
            f.read(4)
            _u16(f.read(2), 0, ">")
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            block = f.read(_u32(f.read(4), 0, ">"))
            if len(block) & 1:
                f.read(1)
    size = _u32(f.read(4), 0, ">")
    if size:
        end = f.tell() + size
        _u32(f.read(4), 0, ">")
        f.seek(end)
    return palette


def _psd_tiles(f: io.BytesIO, channels: int, width: int, height: int):
    """_maketile: the compression and each channel's offset (raw: a
    width x height block a channel, whatever the bits)."""
    compression = _u16(f.read(2), 0, ">")
    offset = f.tell()
    offsets = []
    if compression == 0:
        return compression, [offset + c * width * height
                             for c in range(channels)]
    if compression == 1:
        counts = f.read(channels * height * 2)
        offset = f.tell()
        i = 0
        for _ in range(channels):
            offsets.append(offset)
            for _ in range(height):
                offset += _u16(counts, i, ">")
                i += 2
    return compression, offsets


# ---------------------------------------------------------------- QOI


def decode_qoi(data: bytes) -> np.ndarray:
    """QoiImageFile: the big-endian size, three channels (RGB) or any
    other count (RGBA), then the ops from byte 14 (C++)."""
    f = io.BytesIO(data)
    f.read(4)
    try:
        width, height = _u32(f.read(4), 0, ">"), _u32(f.read(4), 0, ">")
        channels = f.read(1)[0]
    except STEPPED_PAST as e:
        raise Decline(f"QOI: {e}") from None
    mode = "RGB" if channels == 3 else "RGBA"
    _opened(mode, (width, height))
    _check_pixels(width, height)
    bands = 3 if channels == 3 else 4
    out = np.zeros((height, width, bands), np.uint8)
    body = data[14:]
    status = native.library().ecgmm_qoi(body, len(body), bands,
                                        width * height, out.ctypes.data)
    if status:
        raise _bad("QOI data ends inside an op (Pillow: IndexError or "
                   "ValueError in the decoder)")
    return np.ascontiguousarray(out[..., :3])


# ------------------------------------------------- plugins without _accept

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type"}
_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _im_takes(data: bytes) -> bool:
    """ImImageFile._open's header walk: a line feed in the first 100 bytes,
    then "key: value" lines until a NUL, ^Z or the end, one of them a tag
    it knows, then the ^Z before the image data (a short lookup table
    there steps past). A number it cannot parse ends the open: a claim."""
    f = io.BytesIO(data)
    if b"\n" not in f.read(100):
        return False
    f.seek(0)
    n = 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    try:
        while True:
            s = f.read(1)
            if s == b"\r":
                continue
            if not s or s in (b"\0", b"\x1a"):
                break
            s = s + f.readline()
            if len(s) > 100:
                return False
            if s.endswith(b"\r\n"):
                s = s[:-2]
            elif s.endswith(b"\n"):
                s = s[:-1]
            m = _IM_SPLIT.match(s)
            if not m:
                return False
            k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
            if k in ("File size (no of images)", "Scale (x,y)",
                     "Image size (x*y)"):
                v = tuple(map(_im_number, v.replace("*", ",").split(",")))
                if len(v) == 1:
                    v = v[0]
            info[k] = v
            n += k in _IM_TAGS
    except ValueError:
        return True
    if not n:
        return False
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s or "Lut" in info and len(f.read(768)) < 768:
        return False
    size = info["Image size (x*y)"]
    if not isinstance(size, tuple):
        return False  # the tile's (0, 0) + size raises TypeError
    return not (not info["Image type"] or size[0] <= 0 or size[1] <= 0)


def _imt_takes(data: bytes) -> bool:
    """ImtImageFile._open: key/value lines after a line feed in the first
    100 bytes, up to a form feed; it takes the file where they give a
    width, a height and "pixel n8" (a width or height that is no number
    ends the open: a claim)."""
    f = io.BytesIO(data)
    buffer = f.read(100)
    if b"\n" not in buffer:
        return False
    xsize = ysize = 0
    mode = ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
            elif k == b"height":
                ysize = int(v)
        except ValueError:
            return True
        if k == b"pixel" and v == b"n8":
            mode = "L"
    return bool(mode) and xsize > 0 and ysize > 0


def _iptc_int(value) -> int:
    """IptcImagePlugin._i: a field's last four bytes, big-endian."""
    return _u32((b"\0\0\0\0" + value)[-4:], 0, ">")


def _iptc_takes(data: bytes) -> bool:
    """IptcImageFile._open: 0x1C-tagged fields up to the (8, 10) record,
    then the records it needs: (3, 60) the layers, (3, 20) and (3, 30) the
    size, (3, 120) the compression. A field length above 132, or a missing
    or unknown compression, ends the open (a claim)."""
    f = io.BytesIO(data)
    info = {}
    try:
        while True:
            s = f.read(5)
            if not s.strip(b"\x00"):
                break
            tag = s[1], s[2]
            if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
                return False
            size = s[3]
            if size > 132:
                return True
            if size == 128:
                size = 0
            elif size > 128:
                size = _iptc_int(f.read(size - 128))
            else:
                size = _u16(s, 3, ">")
            if tag == (8, 10):
                break
            value = f.read(size) if size else None
            if tag not in info:
                info[tag] = value
            elif isinstance(info[tag], list):
                info[tag].append(value)
            else:
                info[tag] = [info[tag], value]
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = ""
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            if (3, 65) in info:  # the band, read as _open reads it
                _ = info[(3, 65)][0] - 1
        size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
        if (3, 120) not in info or _iptc_int(info[(3, 120)]) not in (1, 5):
            return True
    except STEPPED_PAST:
        return False
    return bool(mode) and size[0] > 0 and size[1] > 0


def _pcd_takes(data: bytes) -> bool:
    """PcdImageFile._open: "PCD_" at byte 2048, and the orientation byte
    1538 bytes on."""
    return data[2048:2052] == b"PCD_" and len(data) >= 2048 + 1539


def _spider_takes(data: bytes) -> bool:
    """SpiderImageFile._open: 27 big- (else little-) endian floats whose
    header fields are whole numbers in a consistent layout, a 2-D image
    (iform 1), a stack header it understands and pixels. A stack field
    that is no number ends the open (a claim), as does an image inside a
    stack (the plugin reads an attribute it never set)."""
    if len(data) < 108:
        return False
    for end in (">", "<"):
        t = struct.unpack(end + "27f", data[:108])
        if _spider_header(t):
            break
    else:
        return False
    h = (99,) + t
    if int(h[5]) != 1:
        return False
    width, height = int(h[12]), int(h[2])
    try:
        istack, image = int(h[24]), int(h[27])
        if istack > 0 and image == 0:
            int(h[26])
    except (ValueError, OverflowError):
        return True
    if istack == 0 and image > 0:
        return True
    if not (image == 0 and istack >= 0):
        return False
    return width > 0 and height > 0


def _gbr_takes(data: bytes) -> bool:
    """GbrImageFile._open: a header of 20 bytes or more, version 1 or 2,
    a width and height, colour depth 1 or 4, version 2's "GIMP"."""
    try:
        size, version, width, height, depth = struct.unpack_from(">5I",
                                                                 data)
        if size < 20 or version not in (1, 2) or not (width and height) \
                or depth not in (1, 4):
            return False
        if version == 2:
            struct.unpack_from(">I", data, 24)
            return data[20:24] == b"GIMP"
    except struct.error:
        return False
    return True


def _pcx_takes(data: bytes) -> bool:
    """PcxImageFile._open: a 68-byte header whose box has pixels (an
    unknown mode after that ends the open: a claim)."""
    if len(data) < 68:
        return False
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def _mpeg_takes(data: bytes) -> bool:
    """MpegImageFile._open: 12-bit width and height after the sequence
    header's start code, both above 0."""
    if len(data) < 7:
        return False
    bits = int.from_bytes(data[4:7], "big")
    return bool(bits >> 12) and bool(bits & 0xFFF)


def _spider_header(t) -> int:
    """isSpiderHeader: the header's byte count, or 0."""
    h = (99,) + t

    def whole(v) -> bool:
        try:
            return v - int(v) == 0
        except (ValueError, OverflowError):
            return False

    if not all(whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


# ------------------------------------------------------------ the table


def _prefix(*magic: bytes):
    return lambda p: p.startswith(magic)


def _i32le(p: bytes) -> Optional[int]:
    return _u32(p) if len(p) >= 4 else None


def _avif(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


def _decoded(decode):
    def open_(data: bytes):
        return decode(data), None, None
    return open_


def _claimed(name: str, takes=None):
    def open_(data: bytes):
        if takes is not None and not takes(data):
            raise Decline(name)
        raise _unsupported(f"{name} upload")
    return open_


_ALWAYS = (lambda p: True)
# Image.ID after Image.open has loaded every plugin: (format, _accept on
# the first 16 bytes, open); open returns (RGB as stored, EXIF, XMP),
# raises Decline where the plugin's _open steps past the file, or
# BadRequest
PLUGINS = (
    ("BMP", _prefix(b"BM"), _decoded(decode_bmp)),
    ("DIB", lambda p: _i32le(p) in _BMP_HEADERS, _decoded(decode_dib)),
    ("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a"),
     _decoded(imdecode._decode_gif)),
    ("JPEG", _prefix(b"\xff\xd8\xff"), imdecode._decode_jpeg),
    ("PPM", lambda p: p[:1] == b"P" and len(p) > 1 and p[1] in b"0123456fy",
     _decoded(imdecode._decode_pnm)),
    ("PNG", _prefix(imdecode.PNG_SIGNATURE), imdecode._decode_png),
    ("AVIF", _avif, _claimed("AVIF")),
    ("BLP", _prefix(b"BLP1", b"BLP2"), _claimed("BLP")),
    ("BUFR", _prefix(b"BUFR", b"ZCZC"), _claimed("BUFR")),
    ("CUR", _prefix(b"\0\0\2\0"), _decoded(decode_cur)),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
     _claimed("PCX", _pcx_takes)),
    ("DCX", lambda p: _i32le(p) == 0x3ADE68B1, _claimed("DCX")),
    ("DDS", _prefix(b"DDS "), _claimed("DDS")),
    ("EPS", lambda p: p.startswith(b"%!PS") or _i32le(p) == 0xC6D3D0C5,
     _claimed("EPS")),
    ("FITS", _prefix(b"SIMPLE"), _claimed("FITS")),
    ("FLI", lambda p: len(p) >= 16 and _u16(p, 4) in (0xAF11, 0xAF12)
     and _u16(p, 14) in (0, 3), _claimed("FLI")),
    ("FTEX", _prefix(b"FTEX"), _claimed("FTEX")),
    ("GBR", lambda p: len(p) >= 8 and _u32(p, 0, ">") >= 20
     and _u32(p, 4, ">") in (1, 2), _claimed("GBR", _gbr_takes)),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _claimed("GRIB")),
    ("HDF5", _prefix(b"\x89HDF\r\n\x1a\n"), _claimed("HDF5")),
    ("JPEG2000", _prefix(b"\xff\x4f\xff\x51",
                         b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"),
     jpeg2000.decode_jpeg2000),
    ("ICNS", _prefix(b"icns"), _claimed("ICNS")),
    ("ICO", _prefix(b"\0\0\1\0"), _decoded(decode_ico)),
    ("IM", _ALWAYS, _claimed("IM", _im_takes)),
    ("IMT", _ALWAYS, _claimed("IMT", _imt_takes)),
    ("IPTC", _ALWAYS, _claimed("IPTC", _iptc_takes)),
    ("MCIDAS", _prefix(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
     _claimed("MCIDAS")),
    ("MPEG", _prefix(b"\x00\x00\x01\xb3"), _claimed("MPEG", _mpeg_takes)),
    ("TIFF", _prefix(*imdecode._TIFF_PREFIXES), imdecode._decode_tiff),
    ("MSP", _prefix(b"DanM", b"LinS"), _claimed("MSP")),
    ("PCD", _ALWAYS, _claimed("PCD", _pcd_takes)),
    ("PIXAR", _prefix(b"\200\350\000\000"), _claimed("PIXAR")),
    ("PSD", _prefix(b"8BPS"), _decoded(decode_psd)),
    ("QOI", _prefix(b"qoif"), _decoded(decode_qoi)),
    ("SGI", lambda p: len(p) >= 2 and _u16(p, 0, ">") == 474,
     _claimed("SGI")),
    ("SPIDER", _ALWAYS, _claimed("SPIDER", _spider_takes)),
    ("SUN", lambda p: len(p) >= 4 and _u32(p, 0, ">") == 0x59A66A95,
     _claimed("SUN")),
    ("TGA", _ALWAYS, _decoded(decode_tga)),
    ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP"
     and p[12:16] in (b"VP8 ", b"VP8L", b"VP8X"), imdecode._decode_webp),
    ("WMF", _prefix(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"),
     _claimed("WMF")),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _claimed("XBM")),
    ("XPM", _prefix(b"/* XPM */"), _claimed("XPM")),
    ("XVTHUMB", _prefix(b"P7 332"), _claimed("XVTHUMB")),
)
