"""The upload decoder: image bytes -> an (H, W, 3) uint8 RGB array, turned
upright by the EXIF orientation.

It is the port's counterpart of the Pillow calls of the JAX HTTP handler
(`ecgmm_tpu/serve/http.py:101-112`),
`np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`, and
aims to be bit-equal to them; the machines the port serves on have no
Pillow. An upload is identified as `Image.open` identifies it: the
plugins in Pillow's order (`Image.ID`, `rasters.PLUGINS`), each one's
`_accept` on the first 16 bytes, the next one tried where a plugin's
`_open` steps past the file (`_decode`); the formats the port does not
decode are refused there by name. It follows libjpeg's decoding defaults,
which Pillow uses:

- baseline, extended sequential and progressive JPEG, Huffman- or
  arithmetic-coded (SOF0-2, SOF9-10; DAC conditioning), and lossless JPEG
  (SOF3: predictors 1-7, point transform), 8-bit samples, 1, 3 or 4
  components (CMYK and YCCK, converted to RGB as Pillow converts them),
  any integral sampling factors, restart markers; the Annex K Huffman
  tables where the file defines none before its first scan, as
  libjpeg-turbo fills them in; the accurate integer inverse DCT ("ISLOW")
  as libjpeg-turbo's SIMD code computes it; libjpeg's block smoothing of a
  progressive image whose scans leave its first coefficients incomplete;
  fancy (triangle) upsampling of 2x1, 1x2 and 2x2 chroma, replication
  otherwise (and always in lossless mode); libjpeg's integer YCbCr->RGB
  arithmetic; the colour space from the JFIF marker, the Adobe APP14
  transform flag or the component ids, as libjpeg guesses it (lossless:
  RGB or CMYK only, as libjpeg converts no colour there); cut and
  corrupt files as libjpeg answers them under Pillow: its Huffman bit
  reader (a code past 16 bits decodes as 0; past a marker, the rest of
  the restart interval stays as it was; a scan that runs past the end of
  the file before a marker is refused), restart resynchronisation, its
  marker reader's refusals, an arithmetic-coded scan that must lie in the
  64 KiB blocks Pillow has handed libjpeg when the scan starts, a
  multi-scan image that must reach its EOI, and a single-scan image's
  trailer, read only as far as the file goes;
- PNG of every bit depth (1, 2, 4, 8 and 16): gray, gray+alpha, RGB, RGBA
  and palette, the five row filters and Adam7 interlacing, converted as
  Pillow converts them (gray of 1, 2 and 4 bits scaled to 0-255, 16-bit
  gray clipped at 255, 16-bit colour by its high byte); the alpha channel
  is dropped as `.convert("RGB")` drops it; the chunks after the image
  data read as Pillow's `load_end` reads them;
- BMP and DIB through Pillow's reading of the bitmap header
  (`rasters.bitmap`): uncompressed at 16 (5-5-5), 24 and 32 bits and with
  1-, 4- and 8-bit palettes (grey ones dropped as Pillow drops them),
  BI_BITFIELDS with the masks Pillow reads, and RLE8 and RLE4 with the
  quirks of Pillow's run decoder; bottom-up and top-down;
- GIF87a and GIF89a: the first frame, its LZW codes, the global and
  local colour tables, interlacing, and the transparency index as the
  fill around a frame smaller than the screen (`_decode_gif`);
- WebP as libwebp 1.6's animation decoder gives it to Pillow: lossy
  (VP8), lossless (VP8L), alpha (ALPH, decoded and dropped), extended
  (VP8X) files and an animation's first frame on its canvas, with
  libwebp's demuxer rules for which files it refuses (`_decode_webp`);
- TIFF and BigTIFF as Pillow's `TiffImagePlugin` reads the first page
  and libtiff 4.7 decodes it under Pillow (`serve/tiff.py`): strips and
  tiles, planar configurations 1 and 2, fill order 2; uncompressed (by
  Pillow's raw decoder), PackBits, LZW (and libtiff's old-style codes),
  Deflate, LZMA, ZSTD, horizontal differencing and the floating-point
  predictor, CCITT RLE (byte- and word-aligned), Group 3 (1-D and 2-D)
  and Group 4, ThunderScan, JPEG (each strip or tile a JPEG after the
  JPEGTables tag's tables, YCbCr converted by libjpeg; YCbCr otherwise
  by libtiff's RGBA reader) and old-style JPEG (`serve/ojpeg.py`); bilevel,
  grey of 1 to 16 bits, 32-bit integers and floats, palettes, RGB and
  RGBA (associated alpha unpremultiplied) of 8 and 16 bits, CMYK,
  converted as Pillow converts each mode; the IFD's orientation applied
  once, inside the load, as Pillow applies it;
- PNM as `PpmImagePlugin` reads it (`_decode_pnm`): P1-P6 (plain and
  binary, maxval 1 to 65535, rescaled as Pillow's decoders round), Pf,
  and Pillow's own P0CMYK, PyP, PyRGBA and PyCMYK;
- ICO, CUR, TGA, PSD and QOI (`serve/rasters.py`);
- JPEG 2000: JP2, JPX and raw codestreams, as Pillow with openjpeg reads
  them (`serve/jpeg2000.py`, the tile decoder in `j2kdec.cpp`);
- the orientation tag of the EXIF block (JPEG APP1 `Exif\\0\\0`, PNG
  `eXIf`, WebP `EXIF` or ImageMagick's "Raw profile type exif" text),
  else of the XMP packet, applied as `ImageOps.exif_transpose` applies
  its 8 cases.

The JPEG scans (`ecgmm_torch/native/jpegscan.cpp`: Huffman-coded,
arithmetic-coded and lossless), the inverse DCT, the block
smoothing, the upsampling, the colour conversion, the PNG row filters,
GIF's LZW, BMP's run lengths and plain PNM's samples (`imdecode.cpp`),
WebP's bitstreams (`webpdec.cpp`), TIFF's PackBits, LZW, CCITT and
ThunderScan codecs and its YCbCr conversion (`tiffdec.cpp`), Zstandard
(`zstddec.cpp`), the run decoders of PSD, TGA and QOI (`rasters.cpp`)
and JPEG 2000's tiers 1 and 2, wavelets and colour transforms
(`j2kdec.cpp`) are C++, built by g++ at first use; the markers, chunks, headers and
directories are parsed here, with libjpeg's marker reader's refusals.
Anything else (hierarchical or lossless arithmetic-coded JPEG, 12-bit
samples, a height set by a DNL marker, all of which Pillow refuses too;
the TIFF layouts `serve/tiff.py` names as unsupported; CIELAB, AVIF,
HTJ2K code-blocks and the other formats Pillow reads) raises
`BadRequest` naming what it met.

An upload may claim any size, so the decoder keeps Pillow's guards
against decompression bombs: a frame of more than `MAX_PIXELS` pixels is
refused before anything is allocated, the PNG image data is inflated only
as far as the header's size needs, a TIFF strip or tile only to the
size libtiff gives it, and a PNG text chunk inflates to at most
`MAX_TEXT_CHUNK` bytes, `MAX_TEXT_MEMORY` in all.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from ecgmm_torch import native
from ecgmm_torch.serve.wire import BadRequest

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Pillow's limits: `Image.open` raises DecompressionBombError above twice
# `Image.MAX_IMAGE_PIXELS`; PngImagePlugin's MAX_TEXT_CHUNK and
# MAX_TEXT_MEMORY bound the inflated text
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
MAX_TEXT_CHUNK = 1024 * 1024
MAX_TEXT_MEMORY = 64 * MAX_TEXT_CHUNK
_NOT_DECODABLE = "'file' is not a decodable image"
_UNSUPPORTED = ("is not supported by the port's upload decoder (ROADMAP.md "
                "section 3)")
_NATIVE_ERRORS = {-1: "bad Huffman table", -3: "bad PNG row filter",
                  -7: "truncated JPEG (its scan runs past the end; Pillow: "
                      "image file is truncated)",
                  -8: "a progressive JPEG's DC value overflows"}
# zigzag position -> natural (row-major) position of an 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# the frames the decoder reads: SOF marker -> (entropy coding, progressive)
_SOF_CODING = {0xC0: ("huffman", False), 0xC1: ("huffman", False),
               0xC2: ("huffman", True), 0xC3: ("lossless", False),
               0xC9: ("arithmetic", False), 0xCA: ("arithmetic", True)}
# the frames it refuses, as libjpeg-turbo 3.1 (so Pillow) refuses them
_SOF_KINDS = {
    0xC5: "hierarchical JPEG", 0xC6: "hierarchical JPEG",
    0xC7: "hierarchical JPEG",
    0xCB: "lossless arithmetic-coded JPEG (libjpeg-turbo has no decoder "
          "for it either)",
    0xCD: "hierarchical arithmetic-coded JPEG",
    0xCE: "hierarchical arithmetic-coded JPEG",
    0xCF: "hierarchical arithmetic-coded JPEG",
}
# marker codes libjpeg's marker reader refuses (JERR_UNKNOWN_MARKER, a
# second SOI): the reserved 0x02-0xBF, JPG, DHP, EXP and JPG0-JPG13
_JPEG_UNKNOWN = frozenset(range(0x02, 0xC0)) | {0xC8, 0xD8, 0xDE, 0xDF} | \
    frozenset(range(0xF0, 0xFE))
_NO_QUANT = np.zeros(64, np.int16)
# PIL.ImageFile.MAXBLOCK: the bytes Pillow hands its decoder a call
_PILLOW_MAXBLOCK = 65536
_XMP_ORIENTATION = rb'tiff:Orientation(="|>)([0-9])'
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                  b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
# ImageOps.exif_transpose: orientation -> the transposition that undoes it
_TRANSPOSE = {
    2: lambda a: a[:, ::-1],                      # FLIP_LEFT_RIGHT
    3: lambda a: a[::-1, ::-1],                   # ROTATE_180
    4: lambda a: a[::-1],                         # FLIP_TOP_BOTTOM
    5: lambda a: a.transpose(1, 0, 2),            # TRANSPOSE
    6: lambda a: np.rot90(a, -1),                 # ROTATE_270
    7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),  # TRANSVERSE
    8: lambda a: np.rot90(a, 1),                  # ROTATE_90
}


# the errors ImageFile.__init__ turns into SyntaxError where a plugin's
# `_open` raises them: Image.open then tries the next plugin
STEPPED_PAST = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
                struct.error)


class Decline(Exception):
    """The plugin's `_open` does not take the file: Image.open tries the
    next plugin."""


def _bad(what: str) -> BadRequest:
    return BadRequest(f"{_NOT_DECODABLE}: {what}")


def _unsupported(what: str) -> BadRequest:
    return BadRequest(f"{_NOT_DECODABLE}: {what} {_UNSUPPORTED}")


def _check_pixels(width: int, height: int) -> None:
    if width * height > MAX_PIXELS:
        raise _bad(f"an image of {width * height} pixels exceeds the limit "
                   f"of {MAX_PIXELS} (a possible decompression bomb)")


def _check(status: int) -> None:
    if status != 0:
        raise _bad(_NATIVE_ERRORS.get(status, f"decoder error {status}"))


def _decode(data: bytes):
    """(RGB as stored, EXIF block, XMP packet) of an upload, from the first
    plugin of Pillow's order (`rasters.PLUGINS`, `Image.ID`) whose
    `_accept` takes the first 16 bytes and whose `_open` does not step
    past the file. Each decoder raises `Decline` where its plugin's
    `_open` would (its header step turns `STEPPED_PAST` into it); an
    error while pixels load ends the open, as it does in Pillow."""
    from ecgmm_torch.serve import rasters

    prefix = data[:16]
    for _, accept, open_ in rasters.PLUGINS:
        try:
            if not accept(prefix):
                continue
        except (IndexError, TypeError, struct.error):
            continue  # Image.open steps past an _accept that raises these
        try:
            return open_(data)
        except Decline:
            continue
    raise _bad("no image plugin identifies it (Pillow: cannot identify "
               "image file)")


def _decode_tiff(data: bytes):
    """A TIFF, turned upright by its IFD's orientation (else its XMP
    packet's), as TiffImageFile.load_end turns it."""
    from ecgmm_torch.serve import tiff
    rgb, orientation, xmp = tiff.decode_tiff(data)
    if orientation is None and xmp is not None:
        if not isinstance(xmp, bytes):
            raise _bad("a TIFF XMP packet that is not bytes")
        m = re.search(_XMP_ORIENTATION, xmp)
        orientation = int(m.group(2)) if m else None
    # TiffImageFile.load_end turns the image itself and drops the tag,
    # so `Image.open(f).convert("RGB")` gives it upright too
    if _hashable(orientation) and orientation in _TRANSPOSE:
        rgb = _TRANSPOSE[orientation](rgb)
    return rgb, None, None


def _hashable(value) -> bool:
    try:
        hash(value)
    except TypeError:
        return False
    return True


# ---------------------------------------------------------------- PNM

# PpmImagePlugin's magic numbers -> mode
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
              b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_PNM_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
              "CMYK": 4}
_PNM_WHITESPACE = b" \t\n\x0b\x0c\r"
_SAFEBLOCK = 1024 * 1024  # PIL.ImageFile.SAFEBLOCK: a plain decoder's read


class _PnmHeader:
    """PpmImageFile._open's reads: the magic number, then tokens."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.read()
            if not c or c in _PNM_WHITESPACE:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self.read()
            if not c:
                break
            if c in _PNM_WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":  # to the end of the line, CR or LF (or the file)
                while self.read() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise _bad("PNM header ends early")
        if len(token) > 10:
            raise _bad("a PNM header token longer than 10 bytes")
        return token

    def integer(self) -> int:
        try:
            return int(self.token())
        except ValueError:
            raise _bad("a PNM header field that is no integer") from None


def _decode_pnm(data: bytes) -> np.ndarray:
    """PBM, PGM, PPM and PFM (P1-P6, Pf) and Pillow's own P0CMYK, PyP,
    PyRGBA and PyCMYK as `PpmImagePlugin` reads them and
    `.convert("RGB")` converts them: binary samples unpacked as stored
    when maxval is 255 (or 65535 for grey, as I;16B), else rescaled by
    Pillow's `ppm` decoder; the plain formats by its `ppm_plain` decoder;
    grey of a maxval above 255 held as mode I (clipped at 255 in RGB); a
    float map bottom-up, its byte order the scale's sign."""
    head = _PnmHeader(data)
    magic = head.magic()
    if magic not in _PNM_MODES:
        raise _bad("not a PNM file")
    mode = _PNM_MODES[magic]
    width, height = head.integer(), head.integer()
    if width <= 0 or height <= 0:
        raise _bad("PNM of no pixels")
    _check_pixels(width, height)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            return _mode_to_rgb("1", _pnm_bitonal(data, head.pos, width,
                                                  height))
        stride = (width + 7) // 8
        rows = _pnm_raw(data, head.pos, stride, height)
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return _mode_to_rgb("1", (1 - bits) * np.uint8(255))
    if mode == "F":
        try:
            scale = float(head.token())
        except ValueError:
            raise _bad("a PFM scale that is no number") from None
        if scale == 0.0 or not np.isfinite(scale):
            raise _bad("a PFM scale that is 0 or not finite")
        rows = _pnm_raw(data, head.pos, 4 * width, height)
        f = rows.view("<f4" if scale < 0 else ">f4")[::-1]
        return _mode_to_rgb("F", f)
    maxval = head.integer()
    if not 0 < maxval < 65536:
        raise _bad(f"PNM maxval {maxval} is not in 1..65535")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = _PNM_BANDS[mode]
    if plain:
        values = _pnm_plain(data, head.pos, width * height * bands, maxval,
                            65535 if mode == "I" else 255)
    elif maxval == 65535 and mode == "I":
        rows = _pnm_raw(data, head.pos, 2 * width, height)
        values = rows.view(">u2")
    elif maxval == 255:
        values = _pnm_raw(data, head.pos, bands * width, height)
    else:  # Pillow's "ppm" decoder: each sample rescaled, rounded
        size = 1 if maxval < 256 else 2
        n = width * height * bands
        raw = data[head.pos:head.pos + size * n]
        if len(raw) < size * n:
            raise _bad("truncated PNM image data (Pillow: not enough image "
                       "data)")
        v = np.frombuffer(raw, np.uint8 if size == 1 else ">u2")
        top = 65535 if mode == "I" else 255
        values = np.minimum(top, np.round(v / maxval * top))
    pixels = np.asarray(values).reshape(height, width, bands)
    return _mode_to_rgb(mode, pixels)


def _pnm_raw(data: bytes, pos: int, row_bytes: int, height: int):
    if pos + row_bytes * height > len(data):
        raise _bad("truncated PNM image data (Pillow: image file is "
                   "truncated)")
    return np.frombuffer(data, np.uint8, row_bytes * height,
                         pos).reshape(height, row_bytes)


def _comment_end(block: bytes, start: int = 0) -> int:
    """PpmPlainDecoder._find_comment_end, its quirk included."""
    a = block.find(b"\n", start)
    b = block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _PnmBlocks:
    """PpmPlainDecoder's reads: 1 MiB blocks from the image data, the
    comments (# to CR or LF, across blocks too) taken out."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.spans = data, pos, False

    def next(self) -> bytes:
        block = self.data[self.pos:self.pos + _SAFEBLOCK]
        self.pos += len(block)
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.data[self.pos:self.pos + _SAFEBLOCK]
                self.pos += len(block)
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def raw_next(self) -> bytes:
        """The next block before comments are taken out (empty at EOF)."""
        return self.data[self.pos:self.pos + 1]


def _pnm_bitonal(data: bytes, pos: int, width: int, height: int):
    """_decode_bitonal: every byte but whitespace must be 0 or 1."""
    blocks = _PnmBlocks(data, pos)
    total = width * height
    out = bytearray()
    while len(out) != total:
        if not blocks.raw_next():
            break
        tokens = b"".join(blocks.next().split())
        if tokens.strip(b"01"):
            raise _bad("a plain PBM byte other than 0 and 1")
        out = (out + tokens)[:total]
    if len(out) < total:
        raise _bad("truncated PNM image data (Pillow: not enough image data)")
    bits = np.frombuffer(bytes(out), np.uint8).reshape(height, width)
    return np.where(bits == ord("0"), 255, 0).astype(np.uint8)


def _pnm_plain(data: bytes, pos: int, total: int, maxval: int,
               top: int) -> np.ndarray:
    """_decode_blocks: decimal samples, each rounded to
    round(value / maxval * top); one longer than 10 bytes, negative or above
    maxval is refused. A block of plain digits is read in C++
    (`ecgmm_pnm_plain`), one holding anything else as Pillow reads it."""
    blocks = _PnmBlocks(data, pos)
    lib = native.library()
    out = []
    got = 0
    half = b""
    while got != total:
        if not blocks.raw_next():
            if not half:
                break
            block = b" "
        else:
            block = blocks.next()
        if half:
            block = half + block
            half = b""
        if block and not block[-1:].isspace():  # Pillow's half token
            cut = max(block.rfind(bytes([c])) for c in _PNM_WHITESPACE) + 1
            half = block[cut:]
            if len(half) > 10:
                raise _bad("a plain PNM sample longer than 10 bytes")
            block = block[:cut]
        v = _pnm_block(lib, block, total - got)
        if np.any(v > maxval):
            raise _bad("a plain PNM sample past maxval (Pillow: channel "
                       "value too large)")
        out.append(np.round(v / maxval * top))
        got += len(v)
    if got < total:
        raise _bad("truncated PNM image data (Pillow: not enough image data)")
    return np.concatenate(out)


def _pnm_block(lib, block: bytes, need: int) -> np.ndarray:
    """The first `need` samples of a block that ends in whitespace."""
    values = np.empty(max(need, 1), np.int64)
    state = np.zeros(2, np.int64)
    n = lib.ecgmm_pnm_plain(block, len(block), values.ctypes.data, need,
                            state.ctypes.data)
    if state[0] < 0 or n >= need:
        return values[:n]
    tokens = block.split()[:need]  # an odd token among those needed
    if any(len(t) > 10 for t in tokens):
        raise _bad("a plain PNM sample longer than 10 bytes")
    try:
        v = np.array([int(t) for t in tokens], np.int64)
    except ValueError:
        raise _bad("a plain PNM sample that is no integer") from None
    if np.any(v < 0):
        raise _bad("a plain PNM sample below 0 (Pillow: channel value is "
                   "negative)")
    return v


def _mode_to_rgb(mode: str, pixels: np.ndarray,
                 palette: Optional[np.ndarray] = None) -> np.ndarray:
    """`.convert("RGB")` of an image of a Pillow mode (`Convert.c`): 1, L
    and LA their grey repeated; I and I;16 clipped at 255; F truncated and
    clipped (NaN 0); P and PA through `palette` (256 x 3; without one,
    every index reads as black); CMYK by cmyk2rgb, each of R, G and B
    nk - MULDIV255(c, nk) with nk = 255 - K and MULDIV255(a, b) =
    ((a*b + 128) >> 8 + a*b + 128) >> 8; any other mode its first three
    bands."""
    if pixels.ndim == 3 and pixels.shape[2] == 1:
        pixels = pixels[:, :, 0]
    first = pixels if pixels.ndim == 2 else pixels[..., 0]
    if mode in ("P", "PA"):
        if palette is None:
            return np.zeros(first.shape + (3,), np.uint8)
        return palette[first]
    if mode in ("1", "L", "LA"):
        grey = first.astype(np.uint8)
    elif mode.startswith("I"):
        grey = np.clip(pixels.astype(np.int64), 0, 255).astype(np.uint8)
    elif mode == "F":
        v = np.nan_to_num(pixels.astype(np.float64), nan=0.0, posinf=255.0,
                          neginf=0.0)
        grey = np.clip(np.trunc(v), 0, 255).astype(np.uint8)
    elif mode == "CMYK":
        nk = 255 - pixels[..., 3:4].astype(np.int32)
        t = pixels[..., :3].astype(np.int32) * nk + 128
        return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)
    else:
        return np.ascontiguousarray(pixels[..., :3], np.uint8)
    return np.repeat(grey[:, :, None], 3, axis=2)


# ---------------------------------------------------------------- GIF

_NATIVE_ERRORS.update({-4: "bad GIF LZW code", -5: "truncated GIF image data",
                       -6: "truncated BMP RLE delta"})
# GIF interlacing: (first row, step) of the four passes
_GIF_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def _gif_palette(raw: bytes):
    """A colour table as Pillow keeps it: None where it is the identity
    grey ramp (Pillow then decodes to mode L, index = grey), else a
    (256, 3) table, the entries past the file's black."""
    n = len(raw) // 3
    table = np.frombuffer(raw, np.uint8, n * 3).reshape(n, 3)
    if np.array_equal(table, np.repeat(np.arange(n, dtype=np.uint8)[:, None],
                                       3, axis=1)):
        return None
    palette = np.zeros((256, 3), np.uint8)
    palette[:n] = table
    return palette


def _gif_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The data sub-blocks from `pos` joined, and the offset after their
    terminator (or the end of the file where it is missing)."""
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos:pos + n])
        pos += n
    return b"".join(parts), pos


def _decode_gif(data: bytes) -> np.ndarray:
    """The first frame of a GIF87a or GIF89a as Pillow's
    `.convert("RGB")` gives it: the LZW codes (C++), rows interlaced or
    not, the frame's local colour table else the global one (an identity
    grey ramp is no table: index = grey), the canvas the size of the
    logical screen (grown to hold the frame) filled with the frame's
    transparency index, else 0, around the frame."""
    if len(data) < 13:
        raise _bad("truncated GIF header")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        global_palette = _gif_palette(data[pos:pos + n])
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise _bad("GIF with no image")
        tag = data[pos]
        pos += 1
        if tag == 0x21:  # an extension: its label, then sub-blocks
            if pos >= len(data):
                raise _bad("GIF with no image")
            label = data[pos]
            pos += 1
            if pos < len(data) and data[pos]:
                first = data[pos + 1:pos + 1 + data[pos]]
                if label == 0xF9 and len(first) >= 4 and first[0] & 1:
                    transparency = first[3]
            _, pos = _gif_blocks(data, pos)
        elif tag == 0x2C:  # the image descriptor
            if pos + 9 > len(data):
                raise _bad("truncated GIF image descriptor")
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            palette = global_palette
            if fflags & 0x80:
                n = 3 << ((fflags & 7) + 1)
                palette = _gif_palette(data[pos:pos + n])
                pos += n
            interlace = bool(fflags & 0x40)
            break
        # any other byte between blocks is skipped, as Pillow skips it
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    if width == 0 or height == 0:
        raise _bad("GIF of no pixels")
    _check_pixels(width, height)
    if pos >= len(data):
        raise _bad("truncated GIF image data")
    min_code = data[pos]
    if not 1 <= min_code <= 8:
        raise _bad(f"GIF LZW minimum code size {min_code}")
    stream, _ = _gif_blocks(data, pos + 1)
    indices = np.zeros(fw * fh, np.uint8)
    written = np.zeros(1, np.int64)
    lib = native.library()
    _check(lib.ecgmm_gif_lzw(stream, len(stream), min_code,
                             indices.ctypes.data, indices.size,
                             written.ctypes.data))
    frame = indices.reshape(fh, fw)
    if interlace:
        order = np.concatenate([np.arange(a, fh, b) for a, b in _GIF_PASSES])
        placed = np.empty_like(frame)
        placed[order] = frame
        frame = placed
    canvas = np.full((height, width), 0 if transparency is None
                     else transparency, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return np.repeat(canvas[:, :, None], 3, axis=2)
    return palette[canvas]


# ---------------------------------------------------------------- WebP

_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
# VP8X flags (libwebp's WebPFeatureFlags) and those it knows
_ANIMATION_FLAG, _XMP_FLAG, _EXIF_FLAG, _ALPHA_FLAG, _ICCP_FLAG = (
    0x02, 0x04, 0x08, 0x10, 0x20)
_WEBP_VALID_FLAGS = 0x3E
_WEBP_STORED = {b"ICCP": _ICCP_FLAG, b"EXIF": _EXIF_FLAG, b"XMP ": _XMP_FLAG}
_NATIVE_ERRORS.update({
    -20: "bad VP8 frame header", -21: "VP8 first partition ends early",
    -22: "premature end of the VP8 data", -23: "bad VP8 partitions",
    -24: "bad VP8L data", -25: "bad WebP alpha data",
    -26: "a WebP frame whose size disagrees with its header"})


def _le24(data: bytes, pos: int) -> int:
    return data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16


class _WebPFrame:
    """A frame as libwebp's demuxer records it: its offset on the canvas,
    its size (the bitstream's), and its image and ALPH chunks as
    (offset of the chunk header, header plus available payload)."""

    def __init__(self):
        self.x = self.y = self.width = self.height = self.num = 0
        self.image = self.alpha = None
        self.complete = False


class _WebPDemux:
    """libwebp's demuxer (`WebPDemux`, demux.c) over a whole file, as
    Pillow's animation decoder runs it: the chunk order, sizes, flags and
    frame bounds it checks, the frames it keeps and the EXIF and XMP
    chunks it stores. A file shorter than its RIFF size is refused; bytes
    past it are ignored."""

    def __init__(self, data: bytes):
        self.data = data
        self.flags = 0
        self.canvas = (0, 0)
        self.is_ext = False
        self.frames = []
        self.chunks = {}
        if len(data) < 20:
            raise _bad("truncated WebP header")
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise _bad(f"WebP RIFF size {riff_size}")
        self.end = riff_size + 8
        if len(data) < self.end:
            raise _bad("truncated WebP file")
        self.start = 12
        if data[12:16] == b"VP8X":
            self._parse_vp8x()
            self._check_extended()
        else:
            self._parse_single_image()

    def _avail(self) -> int:
        return self.end - self.start

    def _need(self, size: int, what: str) -> None:
        if size > self._avail():
            raise _bad(f"truncated WebP {what}")

    def _header(self):
        """The chunk header at `start` (moved past it): fourcc, size, the
        padded size, which must fit in the file."""
        self._need(8, "chunk header")
        fourcc = self.data[self.start:self.start + 4]
        size = struct.unpack_from("<I", self.data, self.start + 4)[0]
        self.start += 8
        if size > _MAX_CHUNK_PAYLOAD:
            raise _bad(f"WebP chunk size {size}")
        padded = size + (size & 1)
        self._need(padded, f"{fourcc.decode('latin-1')!r} chunk")
        return fourcc, size, padded

    def _store_frame(self, num: int, min_size: int, frame: _WebPFrame):
        """libwebp's StoreFrame: an optional ALPH chunk, then a VP8 or VP8L
        chunk; it stops, the header unread, at any other chunk."""
        self._need(max(8, min_size), "frame")
        alpha_chunks = image_chunks = 0
        while True:
            at = self.start
            fourcc, _, padded = self._header()
            chunk = (at, 8 + padded)
            done = False
            if fourcc == b"ALPH" and not alpha_chunks:
                alpha_chunks = 1
                frame.alpha, frame.num = chunk, num
                self.start += padded
            elif fourcc in (b"VP8 ", b"VP8L"):
                if fourcc == b"VP8L" and alpha_chunks:
                    raise _bad("a VP8L frame after an ALPH chunk")
                if image_chunks:
                    done = True
                else:
                    image_chunks = 1
                    frame.width, frame.height = _webp_features(self.data,
                                                               *chunk)
                    frame.image, frame.num = chunk, num
                    frame.complete = True
                    self.start += padded
            else:
                done = True
            if done:
                self.start -= 8
            if self.start == self.end:
                return
            self._need(8, "chunk header")
            if done:
                return

    def _add_frame(self, frame: _WebPFrame) -> None:
        if self.frames and not self.frames[-1].complete:
            raise _bad("a WebP frame after an incomplete one")
        self.frames.append(frame)

    def _parse_single_image(self) -> None:
        if self.frames:
            raise _bad("a second WebP image")
        frame = _WebPFrame()
        self._store_frame(1, 0, frame)
        if not self.flags & _ALPHA_FLAG:
            frame.alpha = None  # alpha without the VP8X flag is dropped
        if not self.is_ext:
            self.canvas = (frame.width, frame.height)
        self._add_frame(frame)

    def _parse_vp8x(self) -> None:
        self.is_ext = True
        self._need(8, "VP8X chunk")
        self.start += 4
        size = struct.unpack_from("<I", self.data, self.start)[0]
        self.start += 4
        if size > _MAX_CHUNK_PAYLOAD or size < 10:
            raise _bad(f"VP8X chunk of {size} bytes")
        size += size & 1
        self._need(size, "VP8X chunk")
        d, p = self.data, self.start
        self.flags = d[p]
        self.canvas = (1 + _le24(d, p + 4), 1 + _le24(d, p + 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            raise _bad(f"WebP canvas of {self.canvas[0]}x{self.canvas[1]}")
        self.start += size
        self._need(8, "chunk header")
        self._parse_vp8x_chunks()

    def _parse_vp8x_chunks(self) -> None:
        is_animation = bool(self.flags & _ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            at = self.start
            fourcc, size, padded = self._header()
            if fourcc == b"VP8X":
                raise _bad("a second VP8X chunk")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or is_animation:
                    raise _bad("a still image in an animated WebP")
                self.start -= 8
                self._parse_single_image()
            elif fourcc == b"ANIM" and not anim_chunks:
                if padded < 6:
                    raise _bad(f"ANIM chunk of {size} bytes")
                anim_chunks = 1
                self.start += padded
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    raise _bad("an ANMF chunk before ANIM")
                self._parse_animation_frame(padded, is_animation)
            else:  # ICCP, EXIF, XMP, a second ANIM, unknown chunks
                if fourcc == b"ANIM" and padded < 6:
                    raise _bad(f"ANIM chunk of {size} bytes")
                flag = _WEBP_STORED.get(fourcc)
                if fourcc != b"ANIM" and (flag is None or self.flags & flag):
                    self.chunks.setdefault(
                        fourcc, self.data[at + 8:at + 8 + size])
                self.start += padded
            if self.start == self.end:
                return
            self._need(8, "chunk header")

    def _parse_animation_frame(self, chunk_size: int, is_animation: bool):
        if chunk_size < 16:
            raise _bad(f"ANMF chunk of {chunk_size} bytes")
        d, p = self.data, self.start
        frame = _WebPFrame()
        frame.x, frame.y = 2 * _le24(d, p), 2 * _le24(d, p + 3)
        frame.width, frame.height = 1 + _le24(d, p + 6), 1 + _le24(d, p + 9)
        self.start += 16
        if frame.width * frame.height >= _MAX_IMAGE_AREA:
            raise _bad(f"ANMF frame of {frame.width}x{frame.height}")
        start = self.start
        self._store_frame(len(self.frames) + 1, chunk_size - 16, frame)
        if self.start - start > chunk_size - 16:
            raise _bad("a WebP frame overruns its ANMF chunk")
        if is_animation and frame.num > 0:
            self._add_frame(frame)

    def _check_extended(self) -> None:
        """libwebp's IsValidExtendedFormat."""
        if not self.frames:
            raise _bad("WebP without a frame")
        if self.flags & ~_WEBP_VALID_FLAGS:
            raise _bad(f"VP8X flags {self.flags:#04x}")
        exact = not self.flags & _ANIMATION_FLAG
        for f in self.frames:
            if exact and f.num > 1:
                raise _bad("a second frame in a still WebP")
            if not f.complete:
                raise _bad("an incomplete WebP frame")
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                raise _bad("an ALPH chunk after its image")
            w, h = self.canvas
            if exact:
                ok = (f.x, f.y, f.width, f.height) == (0, 0, w, h)
            else:
                ok = f.x + f.width <= w and f.y + f.height <= h
            if not ok:
                raise _bad("a WebP frame outside its canvas")


def _webp_features(data: bytes, at: int, size: int):
    """(width, height) of a VP8 or VP8L chunk as `WebPGetFeatures` checks
    it: a VP8 key frame that is shown, whose first partition is shorter
    than the chunk, or a VP8L header of version 0."""
    fourcc = data[at:at + 4]
    chunk_size = struct.unpack_from("<I", data, at + 4)[0]
    b = data[at + 8:at + size]
    if size < 12:
        raise _bad(f"{fourcc.decode('latin-1')!r} chunk too short")
    if fourcc == b"VP8 ":
        if len(b) < 10:
            raise _bad("VP8 chunk too short")
        bits = b[0] | b[1] << 8 | b[2] << 16
        w = (b[6] | b[7] << 8) & 0x3FFF
        h = (b[8] | b[9] << 8) & 0x3FFF
        if (b[3:6] != b"\x9d\x01\x2a" or bits & 1 or (bits >> 1) & 7 > 3
                or not (bits >> 4) & 1 or bits >> 5 >= chunk_size
                or w == 0 or h == 0):
            raise _bad("bad VP8 frame header")
        return w, h
    if len(b) < 5 or b[0] != 0x2F or b[4] >> 5:
        raise _bad("bad VP8L header")
    v = int.from_bytes(b[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1


def _decode_webp(data: bytes, alpha: bool = False):
    """The first frame of a WebP file as Pillow gives it (libwebp's
    animation decoder, RGBA, then `.convert("RGB")`): a still image, or an
    animation's first frame at its offset on a canvas that is black
    around it (the decoder zero-fills the canvas for a key frame, whatever
    the ANIM background colour). The container is parsed here
    (`_WebPDemux`), the bitstreams in C++ (`native/webpdec.cpp`). Returns
    (rgb, exif, xmp), and where `alpha` the canvas's alpha plane as a
    fourth item (0 around the frame, 255 in a frame without alpha), which
    the tests hold against Pillow's RGBA."""
    demux = _WebPDemux(data)
    width, height = demux.canvas
    _check_pixels(width, height)
    frame = demux.frames[0]
    buf = np.frombuffer(data, np.uint8)
    rgb = np.zeros((height, width, 3), np.uint8)
    a = np.zeros((height, width), np.uint8) if alpha else None
    out = rgb[frame.y:, frame.x:]
    a_out = a[frame.y:, frame.x:] if alpha else None
    a_ptr = a_out.ctypes.data if alpha else None
    at, size = frame.image
    lib = native.library()
    if data[at:at + 4] == b"VP8 ":
        alph = alph_n = None
        if frame.alpha is not None:
            alph = buf.ctypes.data + frame.alpha[0] + 8
            alph_n = struct.unpack_from("<I", data, frame.alpha[0] + 4)[0]
        _check(lib.ecgmm_webp_vp8(
            buf.ctypes.data + at + 8, size - 8, alph, alph_n or 0,
            frame.width, frame.height, out.ctypes.data, width * 3,
            a_ptr, width))
        if alpha and frame.alpha is None:
            a_out[:frame.height, :frame.width] = 255
    else:
        _check(lib.ecgmm_webp_vp8l(
            buf.ctypes.data + at + 8, size - 8, frame.width, frame.height,
            out.ctypes.data, width * 3, a_ptr, width))
    exif = demux.chunks.get(b"EXIF") or None
    xmp = demux.chunks.get(b"XMP ") or None
    if alpha:
        return rgb, exif, xmp, a
    return rgb, exif, xmp


def decode_upload(data: bytes) -> np.ndarray:
    """An uploaded JPEG (Huffman- or arithmetic-coded: baseline, extended,
    progressive; or lossless), PNG, GIF, BMP, WebP, TIFF (the first page),
    PNM, JPEG 2000 or another format of `rasters.PLUGINS` as an upright
    (H, W, 3) uint8 RGB array; `BadRequest` for
    what Pillow would refuse and for the other formats and TIFF
    compressions Pillow reads (ROADMAP.md section 3)."""
    rgb, exif, xmp = _decode(data)
    orientation = _orientation(exif, xmp)
    if orientation in _TRANSPOSE:
        rgb = _TRANSPOSE[orientation](rgb)
    return np.ascontiguousarray(rgb)


def decode_image(data: bytes) -> np.ndarray:
    """An image file as stored, (H, W, 3) uint8 RGB, without the EXIF
    turn: Pillow's `Image.open(f).convert("RGB")`, as the training data's
    image reader (`data/sources.load_images`) calls it. (A TIFF's own
    orientation is applied all the same: Pillow applies it while it
    loads the image.)"""
    return np.ascontiguousarray(_decode(data)[0])


# ---------------------------------------------------------------- EXIF


def _orientation(exif: Optional[bytes], xmp) -> object:
    """The orientation Pillow's `getexif()` reports: the EXIF tag's value
    (an int, or None where the tag holds no single integer), else the XMP
    packet's `tiff:Orientation`, else 1."""
    found, value = _exif_orientation(exif) if exif else (False, None)
    if found:
        return value
    if xmp:
        if isinstance(xmp, str):
            xmp = xmp.encode("utf-8", "surrogateescape")
        m = re.search(_XMP_ORIENTATION, xmp)
        if m:
            return int(m.group(2))
    return 1


def _exif_orientation(exif: bytes) -> Tuple[bool, object]:
    """(whether IFD0 holds the orientation tag 0x0112, its value), read
    from a TIFF-structured EXIF block by the reader of TIFF directories
    (`tiff.read_ifd`, Pillow's leniency): the tag's value as Pillow holds
    it, whose first number (a rational as a Fraction) is the orientation
    and bytes or text none."""
    from ecgmm_torch.serve import tiff

    while exif.startswith(b"Exif\x00\x00"):
        exif = exif[6:]
    if not exif:
        return False, None
    if exif[:4] not in _TIFF_PREFIXES:
        raise _bad("the EXIF block is not TIFF-structured")
    if exif[2:4] in (b"\x00\x2b", b"\x2b\x00"):  # BigTIFF: no such EXIF
        return False, None
    end = "<" if exif[:2] == b"II" else ">"
    (offset,) = struct.unpack(end + "L", exif[4:8])
    tags = tiff.read_ifd(exif, offset, end, False)
    if 0x0112 not in tags:
        return False, None
    typ, data = tags[0x0112]
    return True, tiff.tag_value(end, 0x0112, typ, data)


# ---------------------------------------------------------------- JPEG


def jpeg_tables():
    """Empty quantisation and Huffman tables: (qtables, huff_bits,
    huff_vals, huff_defined)."""
    return ({}, np.zeros((8, 17), np.uint8), np.zeros((8, 256), np.uint8),
            set())


class InTiff(NamedTuple):
    """How libtiff hands one strip or tile of a JPEG-in-TIFF to libjpeg,
    whole in memory (no 64 KiB rule)."""
    # its component samples as an (H, W, C) array converted from YCbCr
    # ("ycc") or as coded ("raw"), or (old-style JPEG, "planes") each
    # component's plane as libjpeg's raw data output gives it,
    # downsampled, in whole blocks
    colour: str
    check: Callable  # called on the frame header
    # `jpeg_tables()`: the decompressor's tables, which the strip's
    # markers update and the next strip starts from
    tables: tuple
    # old-style JPEG: where a list, the iMCU row at which a sequential
    # Huffman scan runs dry is appended to it (`_decode_scan`)
    dry: Optional[list] = None


def _decode_jpeg(data: bytes, libtiff: Optional[InTiff] = None):
    """A JPEG file as Pillow decodes it: (RGB, EXIF block, XMP packet);
    or, given `libtiff`, one strip or tile of a JPEG-in-TIFF as libtiff
    reads it, its samples as `libtiff.colour` says."""
    buf = np.frombuffer(data, np.uint8)
    n = len(data)
    pos = 2
    if libtiff is not None:  # libjpeg's tables outlive an image
        qtables, huff_bits, huff_vals, huff_defined = libtiff.tables
    else:
        qtables, huff_bits, huff_vals, huff_defined = jpeg_tables()
    # DAC's conditioning tables, as SOI leaves them: L, U (DC) and Kx (AC)
    arith = np.array([[0] * 16, [1] * 16, [5] * 16], np.uint8)
    restart = 0
    frame = coding = None
    progressive = False
    prog = None  # a progressive image's state (_Progression)
    planes = None  # per component: (offset, rows, columns) of its plane
    coef = None  # the coefficients (lossy) or the samples (lossless)
    comp_q = {}
    in_scan = set()
    jfif = adobe = False
    adobe_transform = None
    exif = xmp = None
    multi_scan = eoi = False
    lib = native.library()
    while True:
        while pos < n and buf[pos] != 0xFF:  # libjpeg skips stray bytes
            pos += 1
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break  # no EOI: libjpeg ends the image there (see below)
        marker = int(buf[pos])
        pos += 1
        if marker == 0xD9:
            eoi = True
            break
        if marker in _JPEG_UNKNOWN or (marker == 0x01 and not in_scan
                                       and libtiff is None):
            # libjpeg's read_markers refuses these; Pillow's own header
            # parser refuses TEM too, ahead of the first scan
            raise _bad(f"JPEG marker 0x{marker:02X} is not readable")
        if 0xD0 <= marker <= 0xD7 or marker in (0x00, 0x01):
            continue  # 0x00: a stuffed 0xFF00, which next_marker skips
        # what libjpeg refuses on the marker alone, before its segment
        if marker in _SOF_KINDS:
            raise _unsupported(_SOF_KINDS[marker])
        if marker in _SOF_CODING and frame is not None:
            raise _bad("two frame headers")
        if marker == 0xDA and frame is None:
            raise _bad("scan before the frame header")
        (length,) = struct.unpack(">H", data[pos:pos + 2].rjust(2, b"\0"))
        if marker == 0xDD and pos + 2 <= n and length != 4:
            raise _bad("bad restart interval")  # get_dri, before reading
        seg = data[pos + 2:pos + length]
        if pos + 2 > n or length < 2 or len(seg) < length - 2:
            if in_scan and not multi_scan and not _libjpeg_refuses_part(
                    marker, length, data[pos + 2:] if pos + 2 <= n else None,
                    frame):
                # libjpeg has output every row; past them it only looks
                # for EOI and, out of data, suspends: Pillow keeps the image
                break
            raise _bad("truncated JPEG marker segment")
        pos += length
        if marker in _SOF_CODING:
            coding, progressive = _SOF_CODING[marker]
            frame = _parse_sof(seg)
            if libtiff is not None:
                libtiff.check(frame)
            if coding == "lossless":
                planes, coef = _allocate_samples(frame)
            else:
                planes, coef = _allocate_planes(frame)
            prog = _Progression(len(frame[2])) if progressive else None
        elif marker == 0xC4:
            _parse_dht(seg, huff_bits, huff_vals, huff_defined)
        elif marker == 0xCC:
            _parse_dac(seg, arith)
        elif marker == 0xDB:
            _parse_dqt(seg, qtables)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:
            if in_scan and not multi_scan:
                raise _bad("a second scan in a single-scan JPEG (libjpeg "
                           "expects its EOI)")
            if not in_scan:
                if coding == "huffman" and not progressive:
                    # jdhuff.c fills them in; jdphuff.c and jdlhuff.c not
                    _default_huffman_tables(lib, huff_bits, huff_vals,
                                            huff_defined)
                # libjpeg buffers the whole image when its first scan
                # leaves components out, or the image is progressive
                multi_scan = (progressive or not seg
                              or seg[0] < len(frame[2]))
            pos = _decode_scan(
                lib, buf, pos, seg, frame, coding, planes, coef, qtables,
                comp_q, in_scan, restart, huff_bits, huff_vals, huff_defined,
                arith, prog, whole=libtiff is not None,
                dry=libtiff.dry if libtiff is not None else None)
            if libtiff is not None and not multi_scan:
                # libtiff has read every row; jpeg_finish_decompress's
                # marker reading after them fails harmlessly
                break
        elif not in_scan and marker == 0xE0:
            jfif = jfif or (seg[:5] == b"JFIF\x00" and len(seg) >= 14)
        elif not in_scan and marker == 0xEE:
            if seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe, adobe_transform = True, seg[11]
        elif not in_scan and marker == 0xE1:
            if seg.startswith(b"Exif\x00\x00"):
                exif = seg if exif is None else exif + seg[6:]
            elif seg.startswith(b"http://ns.adobe.com/xap/1.0/\x00"):
                xmp = seg.split(b"\x00", 1)[1]
    if frame is None or not in_scan:
        raise _bad("truncated JPEG" if frame is None else
                   "JPEG without image data")
    if multi_scan and not eoi:
        # libjpeg reads a buffered image to its EOI before it outputs a
        # row; Pillow, out of data before that, calls the file truncated
        raise _bad("truncated JPEG (a multi-scan image without its EOI)")
    height, width, comps = frame
    if coding == "lossless" and any(c[0] not in in_scan for c in comps):
        # libjpeg leaves such a component's sample buffer unwritten
        raise _bad("a component of a lossless JPEG is in no scan")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if coding == "lossless":
        if libtiff is not None:
            if libtiff.colour == "ycc":
                raise _bad("a lossless JPEG in YCbCr (libjpeg converts no "
                           "colour in lossless mode)")
            jfif = adobe = False
        samples = _lossless_samples(coef, planes, frame, jfif, adobe,
                                    adobe_transform)
    else:
        smooth = progressive and _block_smoothing(prog.bits, comps, comp_q)
        samples = []
        for ci, ((cid, h, v, _), (off, by, bx)) in enumerate(zip(comps,
                                                                planes)):
            dh = -(-height * v // vmax)
            dw = -(-width * h // hmax)
            plane_coef = coef[off:off + by * bx * 64]
            if smooth:
                smoothed = np.empty_like(plane_coef)
                bits, prev = prog.latches(ci)
                _check(lib.ecgmm_jpeg_smooth(
                    plane_coef.ctypes.data, comp_q[cid].ctypes.data, by, bx,
                    -(-dh // 8), -(-dw // 8), v, -(-height // (8 * vmax)),
                    bits.ctypes.data, prev.ctypes.data, prog.last_good,
                    smoothed.ctypes.data))
                plane_coef = smoothed
            plane = np.empty((by * 8, bx * 8), np.uint8)
            # a component no scan named has no coefficients and, for
            # libjpeg, an all-zero dequantisation table: samples of 128
            q = comp_q.get(cid, _NO_QUANT)
            _check(lib.ecgmm_jpeg_idct(plane_coef.ctypes.data, q.ctypes.data,
                                       by, bx, plane.ctypes.data))
            if libtiff is not None and libtiff.colour == "planes":
                samples.append(plane)  # libjpeg's raw data, whole blocks
                continue
            full = _upsample(lib, plane[:dh, :dw], hmax // h, vmax // v)
            samples.append(full[:height, :width])
    if libtiff is not None:
        if libtiff.colour == "planes":
            return samples
        if libtiff.colour == "ycc":
            return _ycc_to_rgb(lib, *samples)
        return np.stack(samples, axis=2)
    if len(comps) == 1:
        return np.repeat(samples[0][:, :, None], 3, axis=2), exif, xmp
    if len(comps) == 4:
        return _cmyk_to_rgb(lib, samples, adobe, adobe_transform), exif, xmp
    if coding == "lossless" or _jpeg_is_rgb(comps, jfif, adobe,
                                            adobe_transform):
        return np.stack(samples, axis=2), exif, xmp
    return _ycc_to_rgb(lib, *samples), exif, xmp


def _lossless_samples(samples, planes, frame, jfif, adobe, adobe_transform):
    """A lossless image's component planes at full size, upsampled by
    replication (libjpeg's fancy upsampling needs a DCT block size above
    1), in the colour space libjpeg reads: lossless decoding converts no
    colour (jdcolor.c refuses it), so a 3-component image must be RGB (no
    JFIF marker, an Adobe transform of 0 if any; libjpeg takes unknown
    component ids as RGB here) and a 4-component one CMYK."""
    height, width, comps = frame
    if len(comps) == 3 and (jfif or (adobe and adobe_transform != 0)):
        raise _bad("a lossless JPEG in YCbCr (libjpeg converts no colour "
                   "in lossless mode)")
    if len(comps) == 4 and adobe and adobe_transform != 0:
        raise _bad("a lossless JPEG in YCCK (libjpeg converts no colour "
                   "in lossless mode)")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    out = []
    for (_, h, v, _), (off, rows, stride) in zip(comps, planes):
        plane = samples[off:off + rows * stride].reshape(rows, stride)
        plane = plane[:-(-height * v // vmax), :-(-width * h // hmax)]
        full = np.repeat(np.repeat(plane, vmax // v, axis=0), hmax // h,
                         axis=1)
        out.append(np.ascontiguousarray(full[:height, :width]))
    return out


def _parse_sof(seg: bytes):
    if len(seg) < 6:
        raise _bad("bad frame header")
    precision, height, width, nf = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise _unsupported(f"{precision}-bit JPEG")
    if height == 0:
        raise _unsupported("a JPEG whose height is set by a DNL marker")
    if width == 0:
        raise _bad("JPEG of width 0")
    _check_pixels(width, height)
    if nf not in (1, 3, 4):
        raise _unsupported(f"{nf}-component JPEG")
    if len(seg) != 6 + 3 * nf:  # libjpeg's get_sof wants the exact length
        raise _bad("bad frame header")
    comps = []
    for i in range(nf):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise _bad("bad frame header")
        # tq is checked where a scan latches the table (lossless uses none)
        comps.append((cid, h, v, tq))
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if any(hmax % c[1] or vmax % c[2] for c in comps):
        raise _unsupported("JPEG with non-integral sampling ratios")
    return height, width, comps


def _allocate_planes(frame):
    """One int16 coefficient buffer for all components, each plane covering
    whole MCUs of the interleaved layout (which covers the non-interleaved
    one too)."""
    height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    planes, off = [], 0
    for _, h, v, _ in comps:
        by, bx = mcus_y * v, mcus_x * h
        planes.append((off, by, bx))
        off += by * bx * 64
    return planes, np.zeros(off, np.int16)


def _allocate_samples(frame):
    """A lossless image's sample buffer: each component's plane covers
    whole MCUs of the interleaved layout (an MCU is h x v samples), all
    planes with the full-size plane's row length."""
    height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    stride = -(-width // hmax) * hmax
    planes, off = [], 0
    for _, _, v, _ in comps:
        rows = -(-height // vmax) * v
        planes.append((off, rows, stride))
        off += rows * stride
    return planes, np.zeros(off, np.uint8)


def _parse_dht(seg, huff_bits, huff_vals, defined):
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise _bad("bad Huffman table")
        tc, th = seg[i] >> 4, seg[i] & 15
        counts = np.frombuffer(seg[i + 1:i + 17], np.uint8)
        total = int(counts.sum(dtype=np.int64))
        vals = seg[i + 17:i + 17 + total]
        if tc > 1 or th > 3 or total > 256 or len(vals) < total:
            raise _bad("bad Huffman table")
        t = 4 * tc + th
        huff_bits[t] = 0
        huff_bits[t, 1:] = counts
        huff_vals[t] = 0
        huff_vals[t, :total] = np.frombuffer(vals, np.uint8)
        defined.add(t)
        i += 17 + total


def _libjpeg_refuses_part(marker, length, avail, frame) -> bool:
    """Whether libjpeg's marker reader raises on a segment the file ends
    inside (`avail`: its bytes after the length field, None where the
    length field itself is cut), before it runs out of data and suspends:
    jdmarker.c's get_dht, get_dqt, get_dac and get_sos check as they read."""
    if avail is None:
        return False
    left = length - 2
    if marker == 0xC4:  # get_dht
        i = 0
        while left > 16:
            if len(avail) < i + 17:
                return False
            index, count = avail[i], sum(avail[i + 1:i + 17])
            left -= 17
            if count > 256 or count > left:
                return True
            if len(avail) < i + 17 + count:
                return False
            left -= count
            if (index & 0x10 and index - 0x10 >= 4) or (
                    not index & 0x10 and index >= 4):
                return True
            i += 17 + count
        return left != 0
    if marker == 0xDB:  # get_dqt
        i = 0
        while left > 0:
            if len(avail) <= i:
                return False
            prec, tq = avail[i] >> 4, avail[i] & 15
            left -= 1
            if tq >= 4:
                return True
            size = 128 if prec else 64
            if len(avail) < i + 1 + size:
                return False
            left -= size
            i += 1 + size
        return left != 0
    if marker == 0xCC:  # get_dac
        i = 0
        while left > 0:
            if len(avail) < i + 2:
                return False
            index, value = avail[i], avail[i + 1]
            left -= 2
            if index >= 32 or (index < 16 and value & 15 > value >> 4):
                return True
            i += 2
        return left != 0
    if marker == 0xDA:  # get_sos, then "EOI expected" in a single scan
        if not avail:
            return False
        ns = avail[0]
        if length != 2 * ns + 6 or not 1 <= ns <= 4:
            return True
        ids = {c[0] for c in frame[2]}
        for j in range(ns):
            if len(avail) < 3 + 2 * j:
                return False
            if avail[1 + 2 * j] not in ids:
                return True
        return len(avail) >= 2 * ns + 4
    return False


def _parse_dac(seg, arith):
    """jdmarker.c get_dac: (index, value) pairs; index 0-15 sets a DC
    table's L (low nibble) and U (high nibble), L <= U; 16-31 an AC
    table's Kx."""
    if len(seg) % 2:
        raise _bad("bad arithmetic conditioning table")
    for index, value in zip(seg[::2], seg[1::2]):
        if index >= 32:
            raise _bad("bad arithmetic conditioning table")
        if index >= 16:
            arith[2, index - 16] = value
        else:
            if value & 15 > value >> 4:
                raise _bad("bad arithmetic conditioning table")
            arith[0, index], arith[1, index] = value & 15, value >> 4


def _default_huffman_tables(lib, huff_bits, huff_vals, defined):
    """libjpeg-turbo's std_huff_tables at the start of a sequential
    Huffman decompression: the tables DC 0, DC 1, AC 0 and AC 1 that no DHT
    marker before the first scan defined are the Annex K tables
    (Motion-JPEG frames omit them)."""
    for slot, t in enumerate((0, 1, 4, 5)):
        if t not in defined:
            _check(lib.ecgmm_jpeg_std_huffman(slot, huff_bits[t].ctypes.data,
                                              huff_vals[t].ctypes.data))
            defined.add(t)


class _Progression:
    """A progressive image's state as libjpeg keeps it: `bits`, each
    component's coefficients' Al so far (-1: not coded), and `prev`, the
    same before the last scan that coded them (jdphuff.c's and jdarith.c's
    start_pass, over zigzag min(Ss, 1)..max(Se, 9)); the scans read; and
    `last_good`, the last iMCU row in which the last scan began an MCU
    with data left."""

    def __init__(self, n_comp: int):
        self.bits = np.full((n_comp, 64), -1, np.int64)
        self.prev = np.zeros((n_comp, 64), np.int64)
        self.scans = 0
        self.last_good = -1

    def start(self, ci: int, ss: int, se: int, al: int) -> None:
        lo, hi = min(ss, 1), max(se, 9) + 1
        self.prev[ci, lo:hi] = self.bits[ci, lo:hi] if self.scans > 1 else 0
        self.bits[ci, ss:se + 1] = al

    def latches(self, ci: int):
        """jdcoefct.c smoothing_ok's latches of zigzag 0-9: now, and before
        the last scan (-1 after a single scan)."""
        bits = self.bits[ci, :10].astype(np.int32)
        prev = (self.prev[ci, :10] if self.scans > 1
                else np.full(10, -1)).astype(np.int32)
        return bits, prev


def _block_smoothing(coef_bits, comps, comp_q) -> bool:
    """Whether libjpeg's output pass smooths a progressive image's blocks
    (jdcoefct.c smoothing_ok): every component's DC is known, its
    quantisation table has no zero among the first coefficients, and
    some component still misses bits of a coefficient among zigzag
    positions 1-9."""
    useful = False
    for (cid, *_), bits in zip(comps, coef_bits):
        q = comp_q.get(cid)
        if q is None or bits[0] < 0:
            return False
        if any(q[_ZIGZAG[k]] == 0 for k in range(10)):
            return False
        useful = useful or bool(np.any(bits[1:10] != 0))
    return useful


def _check_huffman_table(bits, vals, dc_limit=None) -> None:
    """libjpeg's check of a Huffman table a scan uses
    (`jpeg_make_d_derived_tbl`): the codes of each length fit in the code
    space the shorter ones leave, the all-ones code reserved, and a DC
    table's symbols are at most `dc_limit` (15, or 16 in lossless mode).
    The native decoders check the code space too, before they fill their
    lookup tables."""
    code = 0
    for length in range(1, 17):
        code += int(bits[length])
        if code >= 1 << length:
            raise _bad("bad Huffman table")
        code <<= 1
    total = int(bits.sum(dtype=np.int64))
    if dc_limit is not None and np.any(vals[:total] > dc_limit):
        raise _bad("bad Huffman table")


def _parse_dqt(seg, qtables):
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        size = 128 if pq else 64  # libjpeg: any precision but 0 is 16-bit
        body = seg[i + 1:i + 1 + size]
        if tq > 3 or len(body) < size:
            raise _bad("bad quantisation table")
        zz = np.frombuffer(body, ">u2" if pq else np.uint8).astype(np.int64)
        q = np.zeros(64, np.int64)
        q[_ZIGZAG] = zz
        # libjpeg multiplies in ISLOW_MULT_TYPE, a short for 8-bit samples
        qtables[tq] = q.astype(np.uint16).view(np.int16)
        i += 1 + size


def _decode_scan(lib, buf, pos, seg, frame, coding, planes, coef, qtables,
                 comp_q, in_scan, restart, huff_bits, huff_vals, defined,
                 arith, prog=None, whole=False, dry=None) -> int:
    """Decode one scan into `coef` (the samples of a lossless image);
    `prog` (a `_Progression`, updated here) marks a progressive image;
    `whole`: the data is all in memory (libtiff), not handed over by
    Pillow 64 KiB at a time; `dry` (a list): a sequential Huffman scan
    that runs past the end of the data, or meets a restart marker out of
    sequence, appends the iMCU row where that happened and ends there
    (old-style JPEG-in-TIFF: libtiff's source fails there). Returns the
    offset where the marker reader resumes."""
    height, width, comps = frame
    if not seg:
        raise _bad("bad scan header")
    ns = seg[0]
    # libjpeg's get_sos wants the exact length
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        raise _bad("bad scan header")
    ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    if prog is not None and (
            (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
            or (ah != 0 and al != ah - 1) or al > 13):
        raise _bad("bad progression parameters")
    if prog is not None:
        prog.scans += 1
    if coding == "lossless" and not (1 <= ss <= 7 and se == 0 and ah == 0
                                     and al < 8):
        raise _bad("bad lossless scan parameters")
    index = {c[0]: i for i, c in enumerate(comps)}
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if ns > 1 and sum(comps[index[cid]][1] * comps[index[cid]][2]
                      for cid in seg[1:1 + 2 * ns:2] if cid in index) > 10:
        raise _bad("an MCU of more than 10 blocks (libjpeg's "
                   "D_MAX_BLOCKS_IN_MCU)")
    params, offsets = [], []
    named = set()
    for j in range(ns):
        cid, tables = seg[1 + 2 * j], seg[2 + 2 * j]
        if cid not in index or cid in named:
            # get_sos looks the id up among the components not yet named
            raise _bad(f"scan names unknown component {cid}")
        named.add(cid)
        ci = index[cid]
        _, h, v, tq = comps[ci]
        td, ta = tables >> 4, tables & 15
        # the tables this scan decodes with: a progressive scan uses the
        # DC table for a first DC scan, the AC table for an AC scan and
        # none for a DC refinement; a lossless scan only a DC table
        dc_used = prog is None or (ss == 0 and ah == 0)
        ac_used = coding != "lossless" and (prog is None or ss > 0)
        if prog is not None:
            prog.start(ci, ss, se, al)
        if coding != "arithmetic":  # its 16 tables are always defined
            if (dc_used and (td > 3 or td not in defined)) or (
                    ac_used and (ta > 3 or 4 + ta not in defined)):
                raise _bad("scan uses an undefined Huffman table")
            if dc_used:
                _check_huffman_table(huff_bits[td], huff_vals[td],
                                     16 if coding == "lossless" else 15)
            if ac_used:
                _check_huffman_table(huff_bits[4 + ta], huff_vals[4 + ta])
        in_scan.add(cid)
        if coding != "lossless":
            if tq not in qtables:
                raise _bad("component uses an undefined quantisation table")
            comp_q.setdefault(cid, qtables[tq])  # latched at its first scan
        off = planes[ci][0]
        if coding == "lossless":
            params += [h, v, td, -(-width * h // hmax), -(-height * v // vmax),
                       off]
            continue
        _, _, bx = planes[ci]
        if ns == 1:
            h = v = 1
        params += [h, v, td, ta, bx]
        offsets.append(off)
    if ns == 1:
        _, h, v, _ = comps[index[seg[1]]]
        mcus_x = -(-width * h // hmax)
        mcus_y = -(-height * v // vmax)
        if coding != "lossless":
            mcus_x, mcus_y = -(-mcus_x // 8), -(-mcus_y // 8)
    elif coding == "lossless":
        mcus_x, mcus_y = -(-width // hmax), -(-height // vmax)
    else:
        mcus_x = -(-width // (8 * hmax))
        mcus_y = -(-height // (8 * vmax))
    if coding == "lossless":
        if restart % mcus_x:
            raise _bad(f"restart interval {restart} is not a multiple of "
                       f"the {mcus_x} MCUs of an MCU row (lossless JPEG)")
        params = np.array(params, np.int64)
        out = np.zeros(1, np.int64)
        _check(lib.ecgmm_jpeg_lossless_scan(
            buf.ctypes.data, len(buf), pos, ns, params.ctypes.data,
            coef.ctypes.data, planes[0][2], mcus_x, -(-height // vmax),
            restart, ss, al, huff_bits.ctypes.data, huff_vals.ctypes.data,
            out.ctypes.data))
        return int(out[0])
    params = np.array(params, np.int32)
    offsets = np.array(offsets, np.int64)
    if coding == "arithmetic":
        out = np.zeros(2, np.int64)
        _check(lib.ecgmm_jpeg_arith_scan(
            buf.ctypes.data, len(buf), pos, ns, params.ctypes.data,
            coef.ctypes.data, offsets.ctypes.data, mcus_x, mcus_y, restart,
            int(prog is not None), ss, se, ah, al, arith[0].ctypes.data,
            arith[1].ctypes.data, arith[2].ctypes.data, out.ctypes.data))
        # Pillow hands libjpeg 64 KiB more a call; libjpeg reads a scan's
        # header in the first call that holds all of it and decodes the
        # scan in that call, and its arithmetic decoder cannot suspend
        # for more data (jdarith.c get_byte): it fails, and Pillow refuses
        held = min(len(buf), -(-pos // _PILLOW_MAXBLOCK) * _PILLOW_MAXBLOCK)
        if out[1] > held and not whole:
            raise _bad(f"an arithmetic-coded scan reads to byte {out[1]}, "
                       f"past the {held} Pillow has handed libjpeg (its "
                       "arithmetic decoder cannot wait for more)")
        if prog is not None:  # jdarith.c never runs out of data
            prog.last_good = -(-height // (8 * vmax)) - 1
        return int(out[0])
    out = np.zeros(2, np.int64)
    imcu_v = comps[index[seg[1]]][2] if ns == 1 else 1
    scan = lib.ecgmm_jpeg_huffman_scan if dry is None else \
        lib.ecgmm_jpeg_huffman_scan_strict
    status = scan(
        buf.ctypes.data, len(buf), pos, ns, params.ctypes.data,
        coef.ctypes.data, offsets.ctypes.data, mcus_x, mcus_y, restart,
        int(prog is not None), ss, se, ah, al, huff_bits.ctypes.data,
        huff_vals.ctypes.data, imcu_v, out.ctypes.data)
    if status == -7 and dry is not None and prog is None:
        dry.append(int(out[1]))
        return len(buf)
    _check(status)
    if prog is not None:
        prog.last_good = int(out[1])
    return int(out[0])


def _jpeg_is_rgb(comps, jfif, adobe, adobe_transform) -> bool:
    """libjpeg's guess of a 3-component colour space
    (`default_decompress_parms`): JFIF means YCbCr; else the Adobe
    transform flag (0: RGB); else component ids 'R', 'G', 'B' mean RGB;
    anything else YCbCr."""
    if jfif:
        return False
    if adobe:
        return adobe_transform == 0
    return tuple(c[0] for c in comps) == (82, 71, 66)


def _cmyk_to_rgb(lib, samples, adobe, adobe_transform) -> np.ndarray:
    """A 4-component JPEG as Pillow converts it. libjpeg reads it as YCCK
    when an Adobe marker's transform is not 0 (`default_decompress_parms`)
    and returns CMYK, the first three of YCCK as 255 minus libjpeg's
    YCbCr->RGB (`ycck_cmyk_convert`), K as stored. Pillow takes the result
    inverted ("CMYK;I", the Adobe convention) and converts that CMYK
    (`_mode_to_rgb`): its C, M and Y are 255 minus the stored ones, or for
    YCCK the R, G and B of its YCbCr, and its K 255 minus the stored K."""
    if adobe and adobe_transform != 0:
        cmy = _ycc_to_rgb(lib, *samples[:3])
    else:
        cmy = 255 - np.stack(samples[:3], axis=2).astype(np.uint8)
    k = 255 - samples[3].astype(np.uint8)
    return _mode_to_rgb("CMYK", np.concatenate([cmy, k[:, :, None]], axis=2))


def _upsample(lib, x: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg's upsampling of a component plane by (fh, fv)
    (`ecgmm_jpeg_upsample`)."""
    if (fh, fv) == (1, 1):
        return x
    x = np.ascontiguousarray(x)
    out = np.empty((x.shape[0] * fv, x.shape[1] * fh), np.uint8)
    _check(lib.ecgmm_jpeg_upsample(x.ctypes.data, x.shape[0], x.shape[1],
                                   fh, fv, out.ctypes.data))
    return out


def _ycc_to_rgb(lib, y, cb, cr) -> np.ndarray:
    """libjpeg's YCbCr->RGB conversion (`ecgmm_jpeg_ycc_rgb`)."""
    y, cb, cr = (np.ascontiguousarray(p) for p in (y, cb, cr))
    out = np.empty(y.shape + (3,), np.uint8)
    _check(lib.ecgmm_jpeg_ycc_rgb(y.ctypes.data, cb.ctypes.data,
                                  cr.ctypes.data, y.size, out.ctypes.data))
    return out


# ---------------------------------------------------------------- PNG

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths each colour type allows
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _decode_png(data: bytes):
    """PNG as PngImageFile reads it: the chunks before the image data
    strictly (each whole, its CRC checked), the IDAT chunks until the
    image is full, then the chunks after it as `load_end` reads them (no
    CRC checked; a cut chunk header, a chunk type that is no four word
    characters or IEND ends them; a cut chunk body is refused)."""
    pos = 8
    header = palette = None
    exif = xmp = raw_exif = None
    text_bytes = 0

    def chunk(at: int, strict: bool):
        if at + 8 > len(data):
            raise _bad("truncated PNG")
        length, ctype = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + length]
        crc = data[at + 8 + length:at + 12 + length]
        if len(body) < length or (strict and len(crc) < 4):
            raise _bad("truncated PNG")
        if strict and zlib.crc32(ctype + body) != struct.unpack(">I",
                                                                crc)[0]:
            raise _bad(f"PNG chunk {ctype!r} fails its CRC")
        return ctype, body, at + 12 + length

    while True:
        if pos + 8 <= len(data) and data[pos + 4:pos + 8] == b"IDAT" and \
                header is not None:
            break
        ctype, body, pos = chunk(pos, strict=True)
        if header is None and ctype != b"IHDR":
            raise _bad("PNG does not start with IHDR")
        if ctype == b"IHDR":
            header = _parse_ihdr(body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif ctype == b"IEND":
            raise _bad("PNG without image data")
        else:
            text_bytes, exif, xmp, raw_exif = _png_ancillary(
                ctype, body, text_bytes, exif, xmp, raw_exif)
    width, height, depth, color_type, interlace = header
    ch = _PNG_CHANNELS[color_type]
    passes = [p for p in (_pass_dims(width, height, p) for p in (
        ((0, 0, 1, 1),) if interlace == 0 else _ADAM7)) if p[4] and p[5]]

    def row_bytes(pw):
        return -(-pw * ch * depth // 8)

    need = sum(ph * (1 + row_bytes(pw)) for *_, pw, ph in passes)
    # load_read: IDAT after IDAT (a cut one gives what it holds), inflated
    # no further than the image needs; the rest of the chunk the image
    # ends in is skipped
    z = zlib.decompressobj()
    parts, got = [], 0
    while got < need:
        if pos + 8 > len(data) or data[pos + 4:pos + 8] != b"IDAT":
            raise _bad("truncated PNG image data")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        try:
            out = z.decompress(body, need - got)
        except zlib.error as e:
            raise _bad(f"corrupt PNG image data ({e})")
        parts.append(out)
        got += len(out)
        if len(body) < length and got < need:
            raise _bad("truncated PNG image data")
    raw = b"".join(parts)
    while pos + 8 <= len(data):  # load_end: a cut chunk header ends it
        ctype = data[pos + 4:pos + 8]
        if not re.fullmatch(rb"\w{4}", ctype) or ctype == b"IEND":
            break
        ctype, body, pos = chunk(pos, strict=False)
        if ctype != b"IDAT":
            text_bytes, exif, xmp, raw_exif = _png_ancillary(
                ctype, body, text_bytes, exif, xmp, raw_exif)
    if exif is None and raw_exif is not None:
        exif = bytes.fromhex("".join(raw_exif.split("\n")[3:]))
    pixels = np.empty((height, width, ch),
                      np.uint16 if depth == 16 else np.uint8)
    lib = native.library()
    src = np.frombuffer(raw, np.uint8)
    off = 0
    for x0, y0, dx, dy, pw, ph in passes:
        rb = row_bytes(pw)
        rows = np.ascontiguousarray(src[off:off + ph * (1 + rb)])
        out = np.empty((ph, rb), np.uint8)
        _check(lib.ecgmm_png_unfilter(rows.ctypes.data, ph, rb,
                                      max(1, ch * depth // 8),
                                      out.ctypes.data))
        pixels[y0::dy, x0::dx] = _png_samples(out, pw, ch, depth)
        off += ph * (1 + rb)
    return _png_rgb(pixels, color_type, depth, palette), exif, xmp


def _png_ancillary(ctype, body, text_bytes, exif, xmp, raw_exif):
    """The EXIF and XMP an ancillary chunk carries, and the text read so
    far (bounded by MAX_TEXT_MEMORY)."""
    if ctype == b"eXIf":
        exif = b"Exif\x00\x00" + body
    elif ctype in (b"tEXt", b"zTXt", b"iTXt"):
        key, text = _png_text(ctype, body)
        text_bytes += len(text or "")
        if text_bytes > MAX_TEXT_MEMORY:
            raise _bad(f"the PNG's text exceeds {MAX_TEXT_MEMORY} bytes")
        if key == "Raw profile type exif":
            raw_exif = text
        elif key == "XML:com.adobe.xmp":
            xmp = text
    return text_bytes, exif, xmp, raw_exif


def _png_samples(rows: np.ndarray, pw: int, ch: int, depth: int
                 ) -> np.ndarray:
    """Unfiltered rows (ph, row bytes) -> samples (ph, pw, ch): big-endian
    16-bit, or unpacked from 1, 2 or 4 bits, the leftmost first."""
    ph = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(ph, pw, ch)
    if depth == 8:
        return rows.reshape(ph, pw, ch)
    bits = np.unpackbits(rows, axis=1)[:, :pw * ch * depth]
    bits = bits.reshape(ph, pw * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(ph, pw, ch)


def _parse_ihdr(body: bytes):
    if len(body) < 13:
        raise _bad("bad PNG header")
    width, height, depth, color_type, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", body[:13])
    if (color_type not in _PNG_CHANNELS
            or depth not in _PNG_DEPTHS[color_type] or comp or filt
            or interlace > 1):
        raise _bad("bad PNG header")
    if width == 0 or height == 0:
        raise _bad("PNG of size 0")
    _check_pixels(width, height)
    return width, height, depth, color_type, interlace


def _pass_dims(width, height, p):
    """(x0, y0, dx, dy, pass width, pass height) of an interlace pass."""
    x0, y0, dx, dy = p
    return (x0, y0, dx, dy, max(0, -(-(width - x0) // dx)),
            max(0, -(-(height - y0) // dy)))


def _png_text(ctype: bytes, body: bytes):
    key, _, rest = body.partition(b"\x00")
    key = key.decode("latin-1")
    try:
        if ctype == b"tEXt":
            return key, rest.decode("latin-1")
        if ctype == b"zTXt":
            if rest[:1] not in (b"", b"\x00"):
                # chunk_zTXt raises SyntaxError on another method
                raise _bad(f"unknown compression method {rest[0]} in a "
                           "PNG zTXt chunk")
            return key, _inflate_text(rest[1:]).decode("latin-1")
        flag, method = rest[0], rest[1]
        _, _, rest = rest[2:].partition(b"\x00")  # language tag
        _, _, text = rest.partition(b"\x00")      # translated keyword
        if flag:
            text = _inflate_text(text)
        return key, text.decode("utf-8")
    except (zlib.error, UnicodeDecodeError, IndexError):
        return key, None


def _inflate_text(data: bytes) -> bytes:
    """A compressed text chunk's text, refused past MAX_TEXT_CHUNK bytes as
    Pillow refuses it."""
    inflater = zlib.decompressobj()
    text = inflater.decompress(data, MAX_TEXT_CHUNK)
    if inflater.unconsumed_tail:
        raise _bad(f"a PNG text chunk inflates past {MAX_TEXT_CHUNK} bytes")
    return text


def _png_rgb(pixels, color_type, depth, palette) -> np.ndarray:
    """The samples as Pillow's `.convert("RGB")` gives them: gray of 1, 2
    and 4 bits scaled to 0-255 (the modes "1" and "L"), 16-bit gray
    clipped at 255 (the mode "I;16"), 16-bit gray+alpha and colour by the
    high byte of each sample (the raw modes "LA;16B", "RGB;16B")."""
    if depth == 16:
        if color_type == 0:
            pixels = np.minimum(pixels, 255)
        else:
            pixels = pixels >> 8
        pixels = pixels.astype(np.uint8)
    elif depth < 8 and color_type == 0:
        pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    if color_type in (0, 4):  # gray (+ alpha)
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    if color_type in (2, 6):  # RGB (+ alpha)
        return pixels[:, :, :3]
    if palette is None:
        raise _bad("palette PNG without a palette")
    # an index past the palette's end reads black, as in Pillow
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(palette)] = palette[:256]
    return lut[pixels[:, :, 0]]
