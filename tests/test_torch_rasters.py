"""The small upload formats (`ecgmm_torch/serve/rasters.py`: DIB, ICO, CUR,
TGA, PSD and QOI) and the order uploads are identified in, against Pillow
12.1, which the JAX handler decodes uploads with. The bar is
`test_torch_tiff.py`'s `assert_same`: bit equality with
`np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`, or a
refusal where Pillow refuses.

Pillow's writers make DIB, ICO, TGA and QOI files; CUR and PSD files, and
the layouts the writers never make (TGA's 15-bit colour, colour maps with
a first index, flips, RLE BMP headers), are put together here. Each format
also takes 1000 seeded cuts and bit flips from its first byte, which also
walk the identification order: a file whose magic is flipped goes on to
the plugins after it, as in Pillow."""

import hashlib
import io
import json
import os
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from ecgmm_torch.serve import rasters
from ecgmm_torch.serve.imdecode import decode_upload
from ecgmm_torch.serve.wire import BadRequest
from tests.test_torch_tiff import FIXTURES, assert_same, pillow


@pytest.fixture(scope="module")
def image():
    """A 21x29 RGB image: gradients, a flat band and noise."""
    rng = np.random.default_rng(31)
    y, x = np.mgrid[:21, :29]
    img = np.stack([x * 8, y * 11, (x + y) * 5], axis=2) % 256
    img = img + rng.integers(-12, 13, img.shape)
    img[6:11] = (20, 200, 90)
    return np.clip(img, 0, 255).astype(np.uint8)


def saved(img, fmt, mode="RGB", **kwargs) -> bytes:
    im = Image.fromarray(img)
    im = im.quantize(12) if mode == "P" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kwargs)
    return buf.getvalue()


def cases(data: bytes, seed: int, n: int = 500):
    """n cuts and n single-bit flips anywhere in the file."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield data[:int(rng.integers(0, len(data)))]
        flipped = bytearray(data)
        at = int(rng.integers(0, len(data)))
        flipped[at] ^= 1 << int(rng.integers(0, 8))
        yield bytes(flipped)


def same(data: bytes) -> None:
    """`assert_same` for the upload decoder alone (these formats carry no
    orientation)."""
    try:
        want = pillow(data)
    except Exception:
        with pytest.raises(BadRequest):
            decode_upload(data)
        return
    got = decode_upload(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def fuzz(data: bytes, seed: int) -> None:
    assert assert_same(data) == "decoded"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for case in cases(data, seed):
            same(case)


# ---------------------------------------------------------------- DIB


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_dib_written_by_pillow(image, mode):
    data = saved(image, "DIB", mode)
    assert Image.open(io.BytesIO(data)).format == "DIB"
    assert assert_same(data) == "decoded"


def dib(width, height, bits, pixels: bytes, compression=0, palette=b"",
        colors=0, header=40, masks=b"") -> bytes:
    head = struct.pack("<IiiHHIIiiII", header, width, height, 1, bits,
                       compression, len(pixels), 2835, 2835, colors, 0)
    head += bytes(header - len(head))
    return head + masks + palette + pixels


def test_dib_layouts_pillow_does_not_write(image):
    """16-bit 5-5-5, BI_BITFIELDS 5-6-5 and 32-bit, RLE8 and RLE4,
    top-down rows, a grey two-colour palette Pillow drops, a core
    header."""
    rng = np.random.default_rng(3)
    px16 = rng.integers(0, 256, 12 * 4 * 2, np.uint8).tobytes()
    pal = rng.integers(0, 256, 16 * 4, np.uint8).tobytes()
    rle8 = bytes([3, 1, 0, 3, 4, 5, 6, 0, 0, 0, 6, 2, 0, 0, 2, 3, 4, 7,
                  0, 1])
    rle4 = bytes([5, 0x12, 0, 4, 0x34, 0x56, 0, 0, 6, 0x78, 0, 1])
    files = [
        dib(12, 4, 16, px16),
        dib(12, 4, 16, px16, 3, masks=struct.pack("<3I", 0xF800, 0x7E0,
                                                 0x1F)),
        dib(6, -4, 32, rng.integers(0, 256, 96, np.uint8).tobytes(), 3,
            masks=struct.pack("<3I", 0xFF0000, 0xFF00, 0xFF)),
        dib(6, 3, 8, rle8, 1, pal, 16),
        dib(6, 2, 4, rle4, 2, pal, 16),
        dib(6, 2, 1, bytes(8), 0, b"\0\0\0\0\xff\xff\xff\0", 2),
        struct.pack("<IHHHH", 12, 5, 2, 1, 24) + bytes(32),
    ]
    for data in files:
        assert assert_same(data) == "decoded"


def test_bitmap_and_png_quirks(image):
    """A colour count far past the palette's bytes (Pillow keeps each
    index's low byte in its grey check and reads what palette there is);
    a PNG zTXt chunk of an unknown compression method, before and after
    the image data (refused), and a text chunk after it."""
    bmp = bytearray(saved(image, "BMP", "1"))
    struct.pack_into("<I", bmp, 46, 32770)
    assert assert_same(bytes(bmp)) == "decoded"
    png = saved(image, "PNG")
    at = png.index(b"IDAT") - 4
    for method, where in ((1, at), (0, at), (2, len(png) - 12)):
        body = b"k\0" + bytes([method]) + zlib.compress(b"text")
        chunk = struct.pack(">I", len(body)) + b"zTXt" + body + \
            struct.pack(">I", zlib.crc32(b"zTXt" + body))
        data = png[:where] + chunk + png[where:]
        assert assert_same(data) == ("decoded" if method == 0 else
                                     "refused")


def test_dib_cuts_and_flips(image):
    fuzz(saved(image, "DIB", "P"), 1)


# ---------------------------------------------------------------- ICO, CUR


@pytest.mark.parametrize("kind", ["png", "bmp", "bmp_p"])
def test_ico_written_by_pillow(image, kind):
    if kind == "png":
        data = saved(image, "ICO", "RGBA", sizes=[(21, 21), (16, 16)])
    else:
        data = saved(image, "ICO", "P" if kind == "bmp_p" else "RGBA",
                     bitmap_format="bmp", sizes=[(21, 21), (8, 8)])
    assert Image.open(io.BytesIO(data)).format == "ICO"
    assert assert_same(data) == "decoded"


def icon(entries, magic=b"\0\0\1\0") -> bytes:
    """An icon or cursor: a directory of (width, height, colours, bpp,
    image bytes), the images after it."""
    out = magic + struct.pack("<H", len(entries))
    at = 6 + 16 * len(entries)
    blobs = b""
    for w, h, colors, bpp, blob in entries:
        out += struct.pack("<BBBBHHII", w, h, colors, 0, 1, bpp, len(blob),
                           at + len(blobs))
        blobs += blob
    return out + blobs


def icon_bitmap(img, mode="RGB", mask=True) -> bytes:
    """A BMP of `img` without its file header, its height doubled, and
    an AND mask of zeros."""
    body = bytearray(saved(img, "BMP", mode)[14:])
    (h,) = struct.unpack_from("<i", body, 8)
    struct.pack_into("<i", body, 8, 2 * h)
    w = img.shape[1]
    return bytes(body) + (bytes((w + 31) // 32 * 4 * img.shape[0])
                          if mask else b"")


def test_ico_entry_choice_masks_and_alpha(image):
    """The entry Pillow loads (largest, then fewest colours), 32-bit
    entries whose alpha bytes it reads, AND masks, a PNG beside BMPs, a
    mask past the end (refused)."""
    small = image[:8, :8]
    files = [
        icon([(8, 8, 0, 24, icon_bitmap(small)),
              (29, 21, 0, 8, icon_bitmap(image, "P")),
              (29, 21, 16, 4, icon_bitmap(image, "P"))]),
        icon([(29, 21, 0, 32, icon_bitmap(image, "RGBA", mask=False))]),
        icon([(8, 8, 0, 32, icon_bitmap(small)),
              (29, 21, 0, 32, saved(image, "PNG"))]),
        icon([(29, 21, 0, 24, icon_bitmap(image, mask=False))]),
    ]
    got = [assert_same(data) for data in files]
    assert got[:3] == ["decoded"] * 3


@pytest.mark.parametrize("mode", ["1", "P", "RGB"])
def test_cur_files(image, mode):
    """The cursor Pillow picks (a later one only where larger on both
    sides), its bitmap at half height."""
    small = image[:8, :8]
    data = icon([(8, 8, 0, 0, icon_bitmap(small, mode)),
                 (29, 21, 0, 0, icon_bitmap(image, mode)),
                 (29, 8, 0, 0, icon_bitmap(small, mode))], magic=b"\0\0\2\0")
    assert Image.open(io.BytesIO(data)).format == "CUR"
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("kind", ["png", "bmp"])
def test_ico_cuts_and_flips(image, kind):
    if kind == "png":
        fuzz(saved(image, "ICO", "RGBA", sizes=[(21, 21)]), 2)
    else:
        fuzz(icon([(8, 8, 0, 24, icon_bitmap(image[:8, :8])),
                   (29, 21, 0, 8, icon_bitmap(image, "P"))]), 3)


def test_cur_cuts_and_flips(image):
    fuzz(icon([(29, 21, 0, 0, icon_bitmap(image, "P"))], magic=b"\0\0\2\0"),
         4)


# ---------------------------------------------------------------- TGA


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("compression", [None, "tga_rle"])
def test_tga_written_by_pillow(image, mode, compression):
    """Every mode Pillow writes, raw and run-length (1-bit run-length
    files Pillow writes but cannot read: both refuse them)."""
    data = saved(image, "TGA", mode, compression=compression)
    assert Image.open(io.BytesIO(data)).format == "TGA"
    want = "refused" if mode == "1" and compression else "decoded"
    assert assert_same(data) == want


def tga(image_type, width, height, depth, flags, body, cmap=None,
        ident=b"") -> bytes:
    """A TGA header (cmap: (first index, count, entry bits, bytes)), its
    id field, colour map and pixel data."""
    start, count, bits, entries = cmap or (0, 0, 0, b"")
    return bytes([len(ident), int(cmap is not None), image_type]) + \
        struct.pack("<HHBHHHHBB", start, count, bits, 0, 0, width, height,
                    depth, flags) + ident + entries + body


def test_tga_layouts_pillow_does_not_write():
    """15-bit colour, 16-bit and 24-bit colour maps from a first index, an
    id field, the four orientations, runs and literals across rows; and
    what Pillow refuses: a 32-bit map, more than 256 colours, a map on a
    colour image, a colour-mapped image without one, a run past its row,
    1-bit RLE."""
    rng = np.random.default_rng(4)
    w, h = 5, 3
    px = rng.integers(0, 256, w * h * 2, np.uint8).tobytes()
    idx = bytes(rng.integers(0, 40, w * h, np.uint8))
    map16 = rng.integers(0, 256, 40 * 2, np.uint8).tobytes()
    map24 = rng.integers(0, 256, 40 * 3, np.uint8).tobytes()
    decoded = [tga(2, w, h, 16, flags, px) for flags in (0, 0x10, 0x20,
                                                           0x30)]
    decoded += [tga(1, w, h, 8, 0x20, idx, (10, 40, 16, map16), b"id!"),
                tga(1, w, h, 8, 0, idx, (3, 40, 24, map24)),
                tga(3, w, h, 8, 0, idx, (0, 40, 24, map24)),
                tga(11, w, h, 8, 0x20, bytes([0x83, 9, 0x05, 1, 2, 3, 4, 5,
                                              6, 0x84, 7, 0x02, 1, 2, 3])),
                tga(10, w, h, 16, 0, bytes([0x84, 1, 2, 0x84, 3, 4, 0x84,
                                            5, 6]))]
    refused = [tga(1, w, h, 8, 0, idx, (0, 40, 32, map24 + map16[:40])),
               tga(1, w, h, 8, 0, idx, (230, 40, 24, map24)),
               tga(2, w, h, 24, 0, px + px[:w * h], (0, 4, 24, map24[:12])),
               tga(1, w, h, 8, 0, idx),
               tga(11, w, h, 8, 0, bytes([0x85, 9] * 3)),
               tga(11, w, h, 1, 0, bytes([0x82, 0xFF] * 4))]
    for data in decoded:
        assert assert_same(data) == "decoded"
    for data in refused:
        assert assert_same(data) == "refused"


@pytest.mark.parametrize("kind", ["rgb_rle", "mapped"])
def test_tga_cuts_and_flips(image, kind):
    if kind == "rgb_rle":
        fuzz(saved(image, "TGA", "RGB", compression="tga_rle"), 5)
    else:
        fuzz(saved(image, "TGA", "P"), 6)


# ---------------------------------------------------------------- PSD


def packbits(row: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), row[i]])
            i = j
            continue
        j = i
        while j < len(row) and j - i < 128 and not (
                j + 2 < len(row) and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def psd(color_mode, planes, bits=8, compression=1, mode_data=b"",
        resources=b"", layers=b"", channels=None) -> bytes:
    """A PSD: the header, colour mode data, image resources, layer
    section, then the composite image, each plane (rows of bytes) raw or
    PackBits with its row byte counts first."""
    height, row = planes[0].shape
    width = row * 8 if bits == 1 else row
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or len(planes),
                                height, width, bits, color_mode)
    for block in (mode_data, resources, layers):
        out += struct.pack(">I", len(block)) + block
    if compression == 0:
        return out + b"\0\0" + b"".join(p.tobytes() for p in planes)
    rows = [packbits(r.tobytes()) for p in planes for r in p]
    return out + b"\0\1" + b"".join(struct.pack(">H", len(r))
                                    for r in rows) + b"".join(rows)


def psd_resource(rid: int, data: bytes, name=b"") -> bytes:
    name = bytes([len(name)]) + name
    name += b"\0" * (len(name) % 2)
    return b"8BIM" + struct.pack(">H", rid) + name + \
        struct.pack(">I", len(data)) + data + b"\0" * (len(data) % 2)


@pytest.mark.parametrize("compression", [0, 1])
def test_psd_modes(image, compression):
    """Modes RGB, RGBA (four channels), CMYK (inverted), grey, duotone
    and multichannel, palette (with and without its 768-byte table),
    bitmap; extra channels beyond the mode's; resources and a layer
    section stepped over."""
    rng = np.random.default_rng(5)
    planes = [np.ascontiguousarray(image[..., k]) for k in range(3)]
    extra = np.ascontiguousarray(image[..., 0] // 2)
    table = rng.integers(0, 256, 768, np.uint8).tobytes()
    bits = np.packbits(image[..., 1] > 100, axis=1)
    res = psd_resource(1005, b"resolution") + psd_resource(1036, b"x", b"n")
    layers = struct.pack(">I", 8) + bytes(8)
    files = [psd(3, planes, compression=compression, resources=res,
                 layers=layers),
             psd(3, planes + [extra], compression=compression),
             psd(3, planes + [extra, extra], compression=compression),
             psd(4, planes + [extra], compression=compression),
             psd(1, planes[:1], compression=compression),
             psd(8, planes[:1], compression=compression),
             psd(7, planes[:2], compression=compression),
             psd(2, [planes[0] % 16], compression=compression,
                 mode_data=table),
             psd(2, [planes[0] % 16], compression=compression),
             psd(0, [bits], bits=1, compression=compression)]
    for data in files:
        assert assert_same(data) == "decoded"


def test_psd_refusals(image):
    """What Pillow refuses or cannot read: too few channels, 16 bits, a
    compression other than raw and PackBits, a PackBits channel that ends
    early; CIELAB, which Pillow converts through LittleCMS, is refused as
    unsupported."""
    planes = [np.ascontiguousarray(image[..., k]) for k in range(3)]
    cut = psd(3, planes)
    for data in (psd(3, planes[:2]), psd(3, planes, bits=16),
                 psd(3, planes, compression=0)[:-30], cut[:-40],
                 psd(3, planes, compression=1).replace(b"\0\1", b"\0\2",
                                                       1)):
        assert assert_same(data) == "refused"
    lab = psd(9, planes)
    pillow(lab)
    with pytest.raises(BadRequest, match="CIELAB"):
        decode_upload(lab)


@pytest.mark.parametrize("kind", ["rgb", "palette"])
def test_psd_cuts_and_flips(image, kind):
    planes = [np.ascontiguousarray(image[..., k]) for k in range(3)]
    if kind == "rgb":
        fuzz(psd(3, planes + [planes[0]]), 7)
    else:
        table = bytes(range(256)) * 3
        fuzz(psd(2, [planes[0] % 16], mode_data=table, compression=0), 8)


# ---------------------------------------------------------------- QOI


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi_written_by_pillow(image, mode):
    data = saved(image, "QOI", mode)
    assert assert_same(data) == "decoded"


def test_qoi_every_op():
    """Index ops never filled (transparent black), runs past the image,
    diffs and lumas that wrap, RGBA ops in an RGB file, a channel count
    other than 3 or 4 (read as RGBA)."""
    ops = bytes([0xFE, 10, 20, 30, 0x05, 0x6A, 0x9F, 0x33, 0xC2, 0xFF, 1, 2,
                 3, 128, 0x00, 0x45, 0x80, 0x00, 0xC5, 0xFE, 255, 0, 1,
                 0x7F, 0xBF, 0xFF, 0x40, 0xFD])
    for channels in (3, 4, 7):
        data = b"qoif" + struct.pack(">IIBB", 5, 4, channels, 0) + ops
        assert assert_same(data) == "decoded"
    assert assert_same(b"qoif" + struct.pack(">IIBB", 5, 4, 3, 0) +
                       ops[:8]) == "refused"


def test_qoi_cuts_and_flips(image):
    fuzz(saved(image, "QOI", "RGBA"), 9)


# ------------------------------------------------------ identification


def test_the_table_is_image_id():
    """The port's plugin order is Image.ID after Image.open has loaded
    every plugin, in a fresh interpreter (a plugin module imported
    earlier registers earlier: the five Image.open loads first, whose
    signatures are disjoint, may come in another order)."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", "import io\nfrom PIL import Image\ntry:\n"
         "    Image.open(io.BytesIO(b'no plugin takes this'))\n"
         "except Exception:\n    pass\nprint(' '.join(Image.ID))"],
        capture_output=True, text=True, check=True).stdout.split()
    assert [name for name, _, _ in rasters.PLUGINS] == out


# a small file each unported plugin ahead of TGA claims (its _accept, or
# the header its _open checks)
_CLAIMED = {
    "BLP": b"BLP1" + bytes(40), "BUFR": b"BUFR" + bytes(40),
    "PCX": bytes([10, 5, 1, 8]) + bytes(124),
    "DCX": struct.pack("<I", 0x3ADE68B1) + bytes(40),
    "DDS": b"DDS " + bytes(124), "EPS": b"%!PS-Adobe-3.0\n" + bytes(40),
    "FITS": b"SIMPLE  = " + bytes(40),
    "FLI": struct.pack("<IHHHHHH", 0, 0xAF11, 1, 8, 8, 8, 0) + bytes(40),
    "FTEX": b"FTEX" + bytes(40),
    "GBR": struct.pack(">IIIIII", 28, 1, 4, 4, 1, 0x47494D50) + b"b\0" +
    bytes(16),
    "GRIB": b"GRIB\1\2\3\1" + bytes(40),
    "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(40),
    "JPEG2000": b"\xff\x4f\xff\x51" + bytes(40),
    "ICNS": b"icns" + bytes(40),
    "IMT": b"width 4\nheight 4\npixel n8\n\x0c" + bytes(16),
    "IPTC": b"\x1c\x03\x3c\x00\x02\x01\x00" + b"\x1c\x03\x14\x00\x02\x00\x04"
    + b"\x1c\x03\x1e\x00\x02\x00\x04" + b"\x1c\x03\x78\x00\x01\x01"
    + b"\x1c\x08\x0a\x00\x10" + bytes(16),
    "MCIDAS": b"\0\0\0\0\0\0\0\4" + bytes(256),
    "MPEG": b"\0\0\1\xb3\x01\x40\xf0" + bytes(40),
    "MSP": b"DanM" + bytes(40),
    "PCD": bytes(2048) + b"PCD_IPI" + bytes(1600),
    "PIXAR": b"\x80\xe8\0\0" + bytes(600), "SGI": b"\x01\xda" + bytes(600),
    "SUN": struct.pack(">8I", 0x59A66A95, 4, 4, 8, 16, 1, 0, 0) + bytes(16),
}


def _claimed_by_writers(image):
    """Files from Pillow's own writers for the unported plugins it can
    write ahead of TGA."""
    out = {}
    for fmt, mode in (("IM", "L"), ("SPIDER", "F"), ("AVIF", "RGB"),
                      ("JPEG2000", "RGB"), ("ICNS", "RGB"), ("PCX", "RGB"),
                      ("SGI", "RGB"), ("MSP", "1"), ("DDS", "RGB"),
                      ("BLP", "P")):
        im = Image.fromarray(image).convert(mode)
        buf = io.BytesIO()
        try:
            im.resize((32, 32)).save(buf, fmt)
        except Exception:
            continue
        out[fmt] = buf.getvalue()
    return out


def test_unported_plugins_ahead_of_tga_are_refused_by_name(image):
    """Each plugin ahead of TGA the port does not decode claims its file
    in the port too: refused as unsupported, naming the format, never
    decoded (Pillow opens it with that plugin, or fails in it)."""
    names = [n for n, _, _ in rasters.PLUGINS]
    ahead = names[:names.index("TGA")]
    ported = {"BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "CUR", "ICO",
              "TIFF", "PSD", "QOI", "JPEG2000"}
    files = dict(_CLAIMED)
    files.update(_claimed_by_writers(image))
    for name in ahead:
        if name in ported:
            continue
        if name in ("IM", "SPIDER"):
            assert name in files, name
        data = files[name]
        accept = Image.OPEN[name][1]
        if accept is not None:
            assert accept(data[:16]), name
        try:
            assert Image.open(io.BytesIO(data)).format == name
        except Exception:
            pass  # the plugin takes the file and fails in it
        with pytest.raises(BadRequest, match=name.replace("JPEG2000",
                                                          "JPEG 2000")):
            decode_upload(data)


def test_claims_that_pillow_steps_past():
    """A file a plugin's _accept takes but its _open does not (GBR, PCX
    and MPEG headers that fail their checks) goes on to the plugins after
    it: here TGA, which decodes it as Pillow does."""
    body = bytes(range(80))  # an id field of 10 bytes, then 5 x 4 pixels
    for header in (bytes([0, 0, 2, 0, 0, 0, 0, 1]),   # GBR: version 1
                   bytes([10, 0, 2, 0, 5, 0, 0, 0])):  # PCX: empty box
        data = header + struct.pack("<HHHHBB", 0, 0, 5, 4, 24, 0x20) + body
        assert assert_same(data) == "decoded"
    mpeg = b"\0\0\1\xb3\0\0\0" + bytes(60)  # no pixels
    assert assert_same(mpeg) == "refused"


def _broken(*args, **kwargs):
    raise IndexError("a loader fault")


@pytest.mark.parametrize("fixture, module, loader", [
    ("strip_zstd.tif", "tiff", "_libtiff_tiles"),
    ("strip.tga", "rasters", "_tga_rle"),
    ("strip_rle8.dib", "rasters", "load_bitmap"),
    ("strip.psd", "native", "library"),
])
def test_a_fault_while_pixels_load_is_not_stepped_past(monkeypatch, fixture,
                                                       module, loader):
    """Image.open steps past the six errors only where a plugin's `_open`
    raises them: one raised while pixels load ends the open (a 500 over
    HTTP), and no later plugin is offered the bytes."""
    from ecgmm_torch import native
    from ecgmm_torch.serve import tiff
    with open(os.path.join(FIXTURES, fixture), "rb") as f:
        data = f.read()
    owner = {"tiff": tiff, "rasters": rasters, "native": native}[module]
    monkeypatch.setattr(owner, loader, _broken)
    with pytest.raises(IndexError, match="a loader fault"):
        decode_upload(data)


def test_an_icon_fault_while_pixels_load_is_stepped_past(image, monkeypatch):
    """IcoImageFile loads its image inside `_open`, so there the same
    fault makes Image.open try the plugins after ICO."""
    data = saved(image, "ICO", "RGBA", bitmap_format="bmp", sizes=[(21, 21)])
    assert assert_same(data) == "decoded"
    monkeypatch.setattr(rasters, "load_bitmap", _broken)
    with pytest.raises(BadRequest, match="no image plugin identifies it"):
        decode_upload(data)


def test_files_no_plugin_claims_and_formats_past_tga():
    """Bytes no plugin identifies, and the unported plugins after TGA."""
    for data in (b"", b"x", b"\x00" * 30, b"hello world, no image here"):
        assert assert_same(data) == "refused"
    for name, data in (("XBM", b"#define x_width 8\n#define x_height 1\n"
                                b"static char x_bits[] = {0x01};\n"),
                       ("XPM", b"/* XPM */\n" + bytes(20)),
                       ("WMF", b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(40))):
        with pytest.raises(BadRequest, match=name):
            decode_upload(data)


# ---------------------------------------------------------------- fixtures


def make_raster_fixtures() -> dict:
    """The fixtures `chip_smoke.py` decodes on the card for these formats,
    built from the committed `strip.jpg` (decoded by the port): the strip
    (250x2500) posterised to four grey levels as TGA (run-length) and as
    QOI (RGB), as a PackBits PSD and as an RLE8 DIB of a four-entry
    palette; the 250x200 crop strip[:, 600:800] as an RGB run-length TGA,
    and its 250x250 square strip[:, 600:850] as a PNG icon and a 32-bit
    BMP icon beside it, and as an 8-bit cursor. Regenerate them, and
    their entries in `pillow_rgb_sha256.json`, with this function if
    `strip.jpg` changes."""
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        strip = decode_upload(f.read())
    im = Image.fromarray(strip)
    grey = np.asarray(im.convert("L"))
    grey4 = (grey // 64 * 85).astype(np.uint8)
    crop = np.ascontiguousarray(strip[:, 600:800])
    square = np.ascontiguousarray(strip[:, 600:850])

    def save(img, fmt, **kwargs):
        buf = io.BytesIO()
        img.save(buf, fmt, **kwargs)
        return buf.getvalue()

    rle8 = _rle8_dib(grey4 // 85, [0, 0, 0, 85, 85, 85, 170, 170, 170,
                                   255, 255, 255])
    return {
        "strip.tga": save(Image.fromarray(grey4), "TGA",
                          compression="tga_rle"),
        "crop_rgb.tga": save(Image.fromarray(crop), "TGA",
                             compression="tga_rle"),
        "strip.qoi": save(Image.fromarray(grey4).convert("RGB"), "QOI"),
        "strip.psd": psd(1, [grey4]),
        "strip_rle8.dib": rle8,
        "square.ico": icon([(0, 0, 0, 32, save(Image.fromarray(square),
                                               "PNG")),
                            (32, 32, 0, 32, icon_bitmap(square[:32, :32],
                                                        "RGBA", False))]),
        "square.cur": icon([(250, 250, 0, 0, icon_bitmap(
            np.asarray(Image.fromarray(square).quantize(64).convert("RGB")),
            "P"))], magic=b"\0\0\2\0"),
    }


def _rle8_dib(index: np.ndarray, palette) -> bytes:
    """Indices as a BI_RLE8 DIB: runs of up to 255, each row ended."""
    rows = []
    for row in index[::-1]:
        out, i = bytearray(), 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 255:
                j += 1
            out += bytes([j - i, row[i]])
            i = j
        rows.append(bytes(out) + b"\0\0")
    pixels = b"".join(rows) + b"\0\1"
    pal = b"".join(bytes([palette[k + 2], palette[k + 1], palette[k], 0])
                   for k in range(0, len(palette), 3))
    return dib(index.shape[1], index.shape[0], 8, pixels, 1, pal,
               len(palette) // 3)


def test_committed_raster_fixtures():
    """The committed files are what `make_raster_fixtures` builds; Pillow's
    decode of each has the hash in `pillow_rgb_sha256.json`, and the
    port's equals it."""
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    made = make_raster_fixtures()
    assert sum(len(d) for d in made.values()) < 600_000
    for name, data in made.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
        assert assert_same(data) == "decoded"
        rgb = pillow(data)
        assert list(rgb.shape) == hashes[name]["shape"]
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
            hashes[name]["rgb_sha256"]
