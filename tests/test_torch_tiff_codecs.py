"""The TIFF compressions of the port's second TIFF slice against Pillow
(libtiff 4.7 under it): LZMA (34925), ZSTD (50000), word-aligned CCITT RLE
(32771), ThunderScan (32809) and old-style JPEG (6). The bar is
`test_torch_tiff.py`'s: bit equality with Pillow's
`np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`, or a
refusal where Pillow refuses.

Pillow's writer makes the LZMA and ZSTD files; ZSTD frames it never
writes (checksums, content sizes, raw and RLE blocks, skippable frames,
window limits) come from Pillow's own libzstd through ctypes or are put
together here. Word-aligned RLE comes from Pillow's writer and is built
from its CCITT RLE rows, each padded to 16 bits; ThunderScan by an
encoder here; old-style JPEG from Pillow's JPEG bytes, as a JPEG
interchange format stream or as tables and strips of entropy-coded data
split at restart markers. Each codec also takes 1000 seeded cuts and bit
flips."""

import ctypes
import glob
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from ecgmm_torch.serve.imdecode import decode_upload
from ecgmm_torch.serve.wire import BadRequest
from tests.test_torch_tiff import (FIXTURES, _base_tags, _cut_and_flip_cases,
                                   assert_same, assert_same_but_unwritten,
                                   build, pillow, save, strips_of)


@pytest.fixture(scope="module")
def image():
    """A 40x56 RGB image: gradients, a flat block and noise."""
    rng = np.random.default_rng(23)
    y, x = np.mgrid[:40, :56]
    img = np.stack([x * 4, y * 6, (x + y) * 3], axis=2) % 256
    img = img + rng.integers(-15, 16, img.shape)
    img[12:22, 8:30] = (240, 20, 40)
    return np.clip(img, 0, 255).astype(np.uint8)


def same(data: bytes) -> None:
    """`assert_same` for the upload decoder alone (these files carry no
    orientation, so the decode without it is the same)."""
    try:
        want = pillow(data)
    except Exception:
        with pytest.raises(BadRequest):
            decode_upload(data)
        return
    np.testing.assert_array_equal(decode_upload(data), want)


def _fuzz(data: bytes, seed: int, path=None) -> None:
    """1000 seeded cuts and single-bit flips past the header: the port
    decodes what Pillow decodes, bit-equal (but for rows libtiff leaves
    unwritten, where `path` is given), and refuses the rest."""
    assert assert_same(data) == "decoded"
    for case in _cut_and_flip_cases(data, seed, 500):
        if path is None:
            same(case)
        else:
            assert_same_but_unwritten(case, path)


# ---------------------------------------------------------------- LZMA


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "CMYK",
                                  "I;16"])
def test_lzma_written_by_pillow(image, mode):
    im = Image.fromarray(image)
    im = im.quantize(30) if mode == "P" else (
        Image.fromarray(image[..., 0].astype(np.uint16) * 200) if mode ==
        "I;16" else im.convert(mode))
    data = save(im, compression="lzma", rowsperstrip=16)
    assert Image.open(io.BytesIO(data)).tag_v2[259] == 34925
    assert assert_same(data) == "decoded"


def test_lzma_with_predictor_and_a_single_strip(image):
    data = save(Image.fromarray(image), compression="lzma",
                tiffinfo={317: 2})
    assert assert_same(data) == "decoded"


def test_lzma_error_after_the_strip_is_full_is_ignored(image):
    """libtiff stops calling liblzma once a strip is full: a corrupt
    stream end after that is reported and ignored, one before it fails."""
    data = save(Image.fromarray(image).convert("L"), compression="lzma")
    (strip,) = strips_of(data)
    at = data.index(strip)
    late = bytearray(data)
    late[at + len(strip) - 6] ^= 0xFF  # the stream footer
    assert assert_same(bytes(late)) == "decoded"
    early = bytearray(data)
    early[at + 40] ^= 0xFF
    assert assert_same(bytes(early)) == "refused"


def test_lzma_cuts_and_flips(image):
    _fuzz(save(Image.fromarray(image), compression="lzma",
               rowsperstrip=16), 1)


# ---------------------------------------------------------------- ZSTD


def _libzstd():
    from PIL import features

    assert features.version("libtiff")
    libs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(Image.__file__))), "pillow.libs")
    (path,) = glob.glob(os.path.join(libs, "libzstd*.so*"))
    lib = ctypes.CDLL(path)
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    return lib


def zstd_frame(data: bytes, level=3, checksum=0, content=1) -> bytes:
    """A frame from Pillow's libzstd, with or without the XXH64 checksum
    and the content size (ZSTD_c_checksumFlag, ZSTD_c_contentSizeFlag)."""
    lib = _libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        for param, value in ((100, level), (201, checksum), (200, content)):
            lib.ZSTD_CCtx_setParameter(cctx, param, value)
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        assert n < cap
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def blocks_frame(blocks, fhd=0x00, window=0x00, fcs=b"", tail=b"") -> bytes:
    """A frame put together: its descriptor, window byte, content size,
    then (type, payload, size) blocks (0 raw, 1 RLE, 3 reserved)."""
    out = struct.pack("<IB", 0xFD2FB528, fhd)
    out += (b"" if fhd & 0x20 else bytes([window])) + fcs
    for i, (kind, payload, size) in enumerate(blocks):
        head = (size << 3) | (kind << 1) | int(i == len(blocks) - 1)
        out += struct.pack("<I", head)[:3] + payload
    return out + tail


def _zstd_tiff(frames, width, rows) -> bytes:
    return build(_base_tags(width, rows * len(frames), 8, 1, 1, 50000,
                            {278: (3, [rows])}), frames)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "I;16"])
def test_zstd_written_by_pillow(image, mode):
    im = Image.fromarray(image)
    im = im.quantize(30) if mode == "P" else (
        Image.fromarray(image[..., 0].astype(np.uint16) * 200) if mode ==
        "I;16" else im.convert(mode))
    data = save(im, compression="zstd", rowsperstrip=16)
    assert Image.open(io.BytesIO(data)).tag_v2[259] == 50000
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("checksum", [0, 1])
@pytest.mark.parametrize("content", [0, 1])
def test_zstd_frames_of_libzstd(image, level, checksum, content):
    """Compressed blocks at three levels (Huffman literals in one and four
    streams, every sequence table mode), with and without the checksum
    and the content size (one pass where it fits the strip)."""
    grey = np.ascontiguousarray(image[..., 1])
    frames = [zstd_frame(grey[y:y + 20].tobytes(), level, checksum, content)
              for y in (0, 20)]
    assert assert_same(_zstd_tiff(frames, 56, 20)) == "decoded"


def test_zstd_large_strip_of_many_blocks():
    """A 300x600 strip, many 128 KiB blocks, the repeat modes between
    them."""
    rng = np.random.default_rng(5)
    big = rng.integers(0, 256, (300, 600), np.uint8)
    big[::7] = 0
    big[:, 100:300] = big[:, :200] // 2
    data = _zstd_tiff([zstd_frame(big.tobytes(), 5, 1)], 600, 300)
    assert assert_same(data) == "decoded"


def test_zstd_hand_built_frames(image):
    """Raw and RLE blocks, content sizes, windows at libzstd's limit,
    reserved bits and block types, dictionaries, checksums and skippable
    frames, each decoded or refused as libzstd (through libtiff) does."""
    row = np.ascontiguousarray(image[:20, :, 0]).tobytes()  # 1120 bytes
    n = len(row)
    right = struct.pack("<I", 0)
    cases = {
        "raw, window 1 KiB": blocks_frame([(0, row, n)]),
        "raw in two blocks": blocks_frame([(0, row[:500], 500),
                                           (0, row[500:], n - 500)],
                                          window=0x08),
        "RLE then raw": blocks_frame([(1, b"\x07", 200),
                                      (0, row[200:], n - 200)],
                                     window=0x08),
        "more than the strip": blocks_frame([(0, row + b"xyz", n + 3)],
                                            window=0x08),
        "less than the strip": blocks_frame([(0, row[:-1], n - 1)],
                                            window=0x08),
        "skippable first": struct.pack("<II", 0x184D2A50, 3) + b"abc" +
        blocks_frame([(0, row, n)], window=0x08),
        "single segment": blocks_frame([(0, row, n)], fhd=0x60,
                                       fcs=struct.pack("<H", n - 256)),
        "content size short": blocks_frame([(0, row, n)], fhd=0x80,
                                           window=0x08,
                                           fcs=struct.pack("<I", n - 1)),
        "content size right": blocks_frame([(0, row, n)], fhd=0x80,
                                           window=0x08,
                                           fcs=struct.pack("<I", n)),
        "window 2^27": blocks_frame([(0, row, n)], window=17 << 3),
        "window 2^28": blocks_frame([(0, row, n)], window=18 << 3),
        "window too large": blocks_frame([(0, row, n)], window=0xF8),
        "reserved bit": blocks_frame([(0, row, n)], fhd=0x08, window=0x08),
        "dictionary": blocks_frame([(0, row, n)], fhd=0x01, window=0x08,
                                   fcs=b"\x05"),
        "no dictionary": blocks_frame([(0, row, n)], fhd=0x01, window=0x08,
                                      fcs=b"\x00"),
        "checksum wrong": blocks_frame([(0, row, n)], fhd=0x04, window=0x08,
                                       tail=right),
        "checksum cut": blocks_frame([(0, row, n)], fhd=0x04, window=0x08,
                                     tail=b"\0\0"),
        "reserved block": blocks_frame([(3, row, n)], window=0x08),
        "not a frame": b"\x00" * 8 + row,
    }
    got = {}
    for name, frame in cases.items():
        got[name] = assert_same(_zstd_tiff([frame], 56, 20))
    assert got["raw in two blocks"] == got["RLE then raw"] == "decoded"
    assert got["single segment"] == got["window 2^27"] == "decoded"
    assert got["no dictionary"] == got["content size right"] == "decoded"
    for name in ("raw, window 1 KiB", "skippable first", "window 2^28",
                 "window too large", "reserved bit", "dictionary",
                 "checksum wrong", "reserved block", "not a frame",
                 "content size short", "less than the strip"):
        assert got[name] == "refused", name


@pytest.mark.parametrize("checksum", [0, 1])
def test_zstd_cuts_and_flips(image, checksum):
    if checksum:
        frames = [zstd_frame(image[y:y + 20].tobytes(), 3, 1, 1)
                  for y in (0, 20)]
        data = build(_base_tags(56, 40, 8, 2, 3, 50000, {278: (3, [20])}),
                     frames)
    else:
        data = save(Image.fromarray(image), compression="zstd",
                    rowsperstrip=16)
    _fuzz(data, 2 + checksum)


# ------------------------------------------------- word-aligned CCITT RLE


def rlew_strip(bw: np.ndarray, pad: bool = True) -> bytes:
    """Rows of black (True) and white as CCITT modified Huffman codes
    (Pillow's `tiff_ccitt` writer, a row at a time), each padded to an
    even byte count where `pad`."""
    out = b""
    for row in bw:
        im = Image.fromarray((~row[None]).astype(np.uint8) * 255).convert(
            "1")
        (code,) = strips_of(save(im, compression="tiff_ccitt"))
        out += code + (b"\0" if pad and len(code) % 2 else b"")
    return out


def shift_strips(data: bytes, n: int) -> bytes:
    """A file `build` made from strips that each begin with one spare
    byte: StripOffsets moved on by one and StripByteCounts cut by one, so
    each strip starts where the spare byte was (at the other parity)."""
    out = bytearray(data)
    for tag, delta in ((273, 1), (279, -1)):
        entry = out.index(struct.pack("<HHI", tag, 4, n))
        at = entry + 8 if n == 1 else struct.unpack_from("<I", out,
                                                         entry + 8)[0]
        for k in range(n):
            (v,) = struct.unpack_from("<I", out, at + 4 * k)
            struct.pack_into("<I", out, at + 4 * k, v + delta)
    return bytes(out)


def _rlew_tiff(bw, photometric=0, odd=False, pad=True, fill=1):
    h, w = bw.shape
    strips = [rlew_strip(bw[y:y + 10], pad) for y in range(0, h, 10)]
    if fill == 2:
        rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                       np.uint8)
        strips = [rev[np.frombuffer(s, np.uint8)].tobytes() for s in strips]
    tags = _base_tags(w, h, 1, photometric, 1, 32771,
                      {278: (3, [10]), 266: (3, [fill]),
                       279: (4, [len(s) + odd for s in strips])})
    # chunks of even size keep every strip at the first one's parity
    chunks = [b"\0" * odd + s for s in strips]
    chunks = [c + b"\0" * (len(c) % 2) for c in chunks]
    data = build(tags, chunks)
    return shift_strips(data, len(strips)) if odd else data


@pytest.fixture(scope="module")
def bilevel(image):
    return image[..., 1] > 110


def rlew_by_pillow(bw: np.ndarray) -> bytes:
    """Pillow's writer (libtiff's encoder) for compression 32771."""
    im = Image.fromarray((~bw).astype(np.uint8) * 255).convert("1")
    return save(im, compression="tiff_raw_16")


def test_word_aligned_rle_written_by_pillow(bilevel):
    data = rlew_by_pillow(bilevel)
    assert Image.open(io.BytesIO(data)).tag_v2[259] == 32771
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("fill", [1, 2])
def test_word_aligned_rle_hand_built(bilevel, photometric, odd, fill):
    """Rows of Pillow's CCITT RLE each padded to 16 bits, the strips at
    even or odd offsets, both fill orders: decoded (or refused, where
    libtiff's word alignment loses a row's bytes) as Pillow does."""
    data = _rlew_tiff(bilevel, photometric, odd, fill=fill)
    im = Image.open(io.BytesIO(data))
    assert im.tag_v2[259] == 32771
    assert {o % 2 for o in im.tag_v2[273]} == {int(odd)}
    assert_same(data)


def test_word_alignment_follows_the_strip_offset(bilevel):
    """libtiff word-aligns a row by the address of its next byte, which
    for Pillow's mapped file is the file offset: the strip Pillow wrote,
    moved to an odd offset, decodes (or fails) as libtiff has it there."""
    written = rlew_by_pillow(bilevel)
    (strip,) = strips_of(written)
    h, w = bilevel.shape
    photometric = Image.open(io.BytesIO(written)).tag_v2[262]
    tags = _base_tags(w, h, 1, photometric, 1, 32771, {278: (3, [h])})
    even = build(tags, [strip + b"\0" * (len(strip) % 2)])
    tags[279] = (4, [len(strip) + 1])
    odd = shift_strips(build(tags, [b"\0" + strip + b"\0" * (
        (len(strip) + 1) % 2)]), 1)
    assert Image.open(io.BytesIO(odd)).tag_v2[273][0] % 2 == 1
    assert assert_same(even) == "decoded"
    assert_same(odd)


def test_word_aligned_rle_cuts_and_flips(bilevel):
    _fuzz(rlew_by_pillow(bilevel), 4)


# ---------------------------------------------------------------- ThunderScan


def thunder_row(pixels) -> bytes:
    """One row of 4-bit pixels as ThunderScan codes: runs of the last
    pixel (never the row's last pixels, whose bytes libtiff may leave
    alone), 2-bit deltas of three pixels, 3-bit deltas of two, raw
    pixels."""
    out = bytearray()
    last, i, n = 0, 0, len(pixels)
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    while i < n:
        run = 0
        while i + run < n - 1 and pixels[i + run] == last and run < 63:
            run += 1
        if run >= 2:
            out.append(run)
            i += run
            continue
        d = [int(pixels[i + k]) - int(pixels[i + k - 1] if k else last)
             for k in range(min(3, n - i))]
        if len(d) == 3 and all(v in two for v in d):
            out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
            last = pixels[i + 2]
            i += 3
        elif len(d) >= 2 and all(v in three for v in d[:2]):
            out.append(0x80 | three[d[0]] << 3 | three[d[1]])
            last = pixels[i + 1]
            i += 2
        else:
            out.append(0xC0 | int(pixels[i]))
            last = pixels[i]
            i += 1
    return bytes(out)


def thunder_random(rng, width, rows) -> bytes:
    """Random ThunderScan rows, each op within the row (a run may reach
    its end), skip codes included."""
    out = bytearray()
    for _ in range(rows):
        left = width
        while left:
            k = int(rng.integers(0, 4))
            if k == 0 and left > 1:
                n = int(rng.integers(0, min(63, left) + 1))
                out.append(n)
                left -= n
            elif k == 1 and left >= 3:
                out.append(0x40 | int(rng.integers(0, 64)))
                left -= sum((out[-1] >> s) & 3 != 2 for s in (4, 2, 0))
            elif k == 2 and left >= 2:
                out.append(0x80 | int(rng.integers(0, 64)))
                left -= ((out[-1] >> 3) & 7 != 4) + (out[-1] & 7 != 4)
            else:
                out.append(0xC0 | int(rng.integers(0, 16)))
                left -= 1
    return bytes(out)


def _thunder_tiff(strips, width, rows, photometric=1, height=None):
    return build(_base_tags(width, height or rows * len(strips), 4,
                            photometric, 1, 32809, {278: (3, [rows])}),
                 strips)


@pytest.mark.parametrize("photometric", [0, 1])
def test_thunderscan_encoded_image(image, photometric):
    grey = (image[..., 0].astype(np.int32) * 16 // 256).astype(np.uint8)
    strips = [b"".join(thunder_row(r) for r in grey[y:y + 8])
              for y in range(0, 40, 8)]
    data = _thunder_tiff(strips, 56, 8, photometric)
    assert assert_same(data) == "decoded"
    want = grey * 17 if photometric else (15 - grey) * 17
    np.testing.assert_array_equal(decode_upload(data)[..., 0], want)


def test_thunderscan_random_ops(tmp_path):
    """Every op at every position: runs from odd pixels, runs that end the
    row, skip codes, deltas that wrap."""
    rng = np.random.default_rng(11)
    strips = [thunder_random(rng, 37, 6) for _ in range(3)]
    assert assert_same_but_unwritten(_thunder_tiff(strips, 37, 6),
                                     tmp_path / "t.tif") == "decoded"


def test_thunderscan_rows_that_run_short_or_over():
    short = _thunder_tiff([bytes([0xC3, 0x02])], 4, 1)
    over = _thunder_tiff([bytes([0xC3, 0x04])], 4, 1)
    exact = _thunder_tiff([bytes([0xC3, 0x03])], 4, 1)
    assert assert_same(short) == assert_same(over) == "refused"
    assert assert_same(exact) == "decoded"
    bits8 = build(_base_tags(4, 1, 8, 1, 1, 32809, {278: (3, [1])}),
                  [bytes([0xC3] * 4)])
    assert assert_same(bits8) == "refused"


def test_thunderscan_cuts_and_flips(tmp_path):
    rng = np.random.default_rng(12)
    strips = [thunder_random(rng, 37, 6) for _ in range(2)]
    _fuzz(_thunder_tiff(strips, 37, 6), 5, tmp_path / "t.tif")


# ---------------------------------------------------------- old-style JPEG


def jpeg_bytes(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def jpeg_parts(j: bytes):
    """(quantisation tables by id, DC and AC Huffman tables by id as
    counts + symbols, the entropy-coded data split at restart markers)."""
    pos, q, dc, ac = 2, {}, {}, {}
    while True:
        marker = j[pos + 1]
        (length,) = struct.unpack(">H", j[pos + 2:pos + 4])
        body = j[pos + 4:pos + 2 + length]
        if marker == 0xDB:
            while body:
                q[body[0] & 15], body = body[1:65], body[65:]
        elif marker == 0xC4:
            while body:
                n = sum(body[1:17])
                (ac if body[0] >> 4 else dc)[body[0] & 15] = body[1:17 + n]
                body = body[17 + n:]
        elif marker == 0xDA:
            data = j[pos + 2 + length:j.rindex(b"\xff\xd9")]
            break
        pos += 2 + length
    parts, start, i = [], 0, 0
    while i < len(data) - 1:
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            parts.append(data[start:i])
            start = i = i + 2
        else:
            i += 1
    parts.append(data[start:])
    return q, dc, ac, parts


_SUBSAMPLING = {(2, 2): 2, (2, 1): 1, (1, 1): 0}


def ojpeg_interchange(img, sampling=(2, 2), photometric=6, **kwargs):
    """Old-style JPEG as the JPEGInterchangeFormat stream (Pillow's JPEG,
    whole), its one strip the same bytes."""
    h, w = img.shape[:2]
    spp = 3 if img.ndim == 3 else 1
    j = jpeg_bytes(img, subsampling=_SUBSAMPLING[sampling], **kwargs) \
        if spp == 3 else jpeg_bytes(img, **kwargs)
    tags = _base_tags(w, h, 8, photometric, spp, 6, {278: (3, [h])})
    if spp == 3:
        tags[530] = (3, list(sampling))
    tags[513], tags[514] = (4, [0]), (4, [len(j)])
    at = build(tags, [j]).index(j)
    tags[513] = (4, [at])
    data = build(tags, [j])
    assert data.index(j) == at
    return data


def ojpeg_tables(img, sampling=(2, 2), photometric=6, mcu_rows=1,
                 shared=True, quality=75):
    """Old-style JPEG in its tables form: JPEGQTables, JPEGDCTables and
    JPEGACTables pointing at the tables (the chroma components' shared
    where `shared`), each strip one restart interval of Pillow's
    entropy-coded data."""
    h, w = img.shape[:2]
    spp = 3 if img.ndim == 3 else 1
    j = jpeg_bytes(img, subsampling=_SUBSAMPLING[sampling],
                   restart_marker_rows=mcu_rows, quality=quality) \
        if spp == 3 else jpeg_bytes(img, restart_marker_rows=mcu_rows,
                                    quality=quality)
    q, dc, ac, parts = jpeg_parts(j)
    ids = [0, 1, 1] if spp == 3 else [0]
    slots = ids if shared else list(range(spp))
    blob, where = b"", {}
    for slot, t in zip(slots, ids):
        if slot not in where:
            where[slot] = len(blob)
            blob += q[t] + dc[t] + ac[t]
    rows = 8 * (sampling[1] if spp == 3 else 1) * mcu_rows
    tags = _base_tags(w, h, 8, photometric, spp, 6, {278: (3, [rows]),
                                                     65000: (7, blob)})
    if spp == 3:
        tags[530] = (3, list(sampling))
    for tag in (519, 520, 521):
        tags[tag] = (4, [0] * spp)
    base = build(tags, parts).index(blob)
    for k, tag in enumerate((519, 520, 521)):
        tags[tag] = (4, [base + where[slot] + (0, 64, 64 + len(
            dc[ids[c]]))[k] for c, slot in enumerate(slots)])
    data = build(tags, parts)
    assert data.index(blob) == base
    return data


@pytest.mark.parametrize("width", [32, 50, 250])
@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 1)])
def test_old_jpeg_interchange_format(width, sampling):
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, (24, width, 3), np.uint8)
    img[:, ::3] //= 2
    assert assert_same(ojpeg_interchange(img, sampling)) == "decoded"


def test_old_jpeg_grey_and_rgb(image):
    """Grey through libjpeg's samples; photometric RGB, which libtiff
    takes as YCbCr in old-style JPEG."""
    assert assert_same(ojpeg_interchange(image[..., 1], photometric=1)) \
        == "decoded"
    assert assert_same(ojpeg_interchange(image, photometric=2)) \
        == "decoded"
    assert assert_same(ojpeg_tables(image[..., 2], photometric=1)) \
        == "decoded"


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 1)])
@pytest.mark.parametrize("shared", [False, True])
def test_old_jpeg_tables_and_strips(image, sampling, shared):
    """The tables form: a restart marker written between strips, a restart
    interval of one strip's MCUs, the last strip short."""
    data = ojpeg_tables(image[:37], sampling, shared=shared)
    assert len(Image.open(io.BytesIO(data)).tag_v2[273]) > 1
    assert assert_same(data) == "decoded"


def test_old_jpeg_refusals(image):
    """What libtiff refuses in old-style JPEG, refused by both: missing
    tables, a progressive frame, a frame shorter than the image, strips
    not whole MCU rows."""
    good = ojpeg_interchange(image)
    progressive = ojpeg_interchange(image, progressive=True)
    no_tables = ojpeg_tables(image)
    for tag in (519,):
        entry = struct.pack("<HHI", tag, 4, 3)
        at = no_tables.index(entry)
        no_tables = no_tables[:at] + struct.pack("<HHI", 64999, 4, 3) + \
            no_tables[at + 8:]
    sof = good.index(b"\xff\xc0")
    taller = bytearray(good)
    taller[sof + 5:sof + 7] = struct.pack(">H", 23)
    wrong_rows = ojpeg_tables(image).replace(
        struct.pack("<HHIHH", 278, 3, 1, 16, 0),
        struct.pack("<HHIHH", 278, 3, 1, 12, 0))
    for data in (no_tables, bytes(taller), wrong_rows, progressive):
        assert assert_same(data) == "refused"


def test_a_scan_naming_a_component_twice(image):
    """libjpeg's get_sos refuses a scan that names a component twice, in
    a JPEG upload and in old-style JPEG alike."""
    j = jpeg_bytes(image, subsampling=2)
    sos = j.index(b"\xff\xda")
    twice = bytearray(j)
    twice[sos + 9] = twice[sos + 7]  # the third component named as the second
    assert assert_same(bytes(twice)) == "refused"
    whole = ojpeg_interchange(image)
    at = whole.index(j) + sos + 9
    ojpeg = bytearray(whole)
    ojpeg[at] = ojpeg[at - 2]
    assert assert_same(bytes(ojpeg)) == "refused"


def test_old_jpeg_edges_of_its_input(image):
    """A JPEG interchange format stream cut inside its scan header (libtiff
    skips the last header bytes only within that stream, so the data
    starts at the strip's first byte), and StripByteCounts missing (no
    further fix-up in old-style JPEG: the strips cannot be read, which
    fails the image unless the interchange format stream holds it all)."""
    img = np.ascontiguousarray(image[:19, :23])
    j = jpeg_bytes(img, subsampling=0)
    sos = j.index(b"\xff\xda")
    head = sos + 2 + struct.unpack(">H", j[sos + 2:sos + 4])[0]
    whole = ojpeg_interchange(img, (1, 1))
    at = whole.index(j)
    got = [assert_same(whole[:at + cut]) for cut in range(head - 5, head + 3)]
    assert "decoded" in got
    for with_jif in (False, True):
        data = ojpeg_interchange(img, (1, 1)) if with_jif else \
            ojpeg_tables(image)
        entry = data.index(struct.pack("<HHI", 279, 4, 1) if with_jif else
                           struct.pack("<HHI", 279, 4, 3))
        no_counts = data[:entry] + struct.pack("<H", 65001) + \
            data[entry + 2:]
        assert assert_same(no_counts) == ("decoded" if with_jif else
                                          "refused")


def test_old_jpeg_strips_past_the_end(image):
    """A strip past the end of the file: libtiff's source fails at the
    first MCU it cannot read; one strip after it fails the image, the
    last strip alone reads as nothing."""
    data = ojpeg_tables(image)
    offsets = Image.open(io.BytesIO(data)).tag_v2[273]
    for k in range(len(offsets)):
        cut = bytearray(data)
        entry = cut.index(struct.pack("<HHI", 273, 4, len(offsets)))
        (at,) = struct.unpack_from("<I", cut, entry + 8)
        struct.pack_into("<I", cut, at + 4 * k, len(data) + 100)
        assert_same(bytes(cut))


@pytest.mark.parametrize("kind", ["interchange", "tables", "grey"])
def test_old_jpeg_cuts_and_flips(image, kind, tmp_path):
    if kind == "interchange":
        _fuzz(ojpeg_interchange(image[:24, :40]), 6)
    elif kind == "tables":
        _fuzz(ojpeg_tables(image), 7)
    else:
        _fuzz(ojpeg_tables(image[..., 0], photometric=1), 8,
              tmp_path / "g.tif")


# ---------------------------------------------------------------- fixtures


def make_codec_fixtures() -> dict:
    """The fixtures `chip_smoke.py` decodes on the card for these codecs,
    built from the committed `strip.jpg` (decoded by the port), at its
    250x2500 size: RGB as LZMA with predictor 2 and as ZSTD (16-row
    strips); the strip binarised at grey 160 as word-aligned RLE (10-row
    strips); its grey in 16 levels as ThunderScan (8-row strips); the
    strip as YCbCr 2x2 old-style JPEG in its tables form (16-row strips,
    Pillow's JPEG at quality 75). Regenerate them, and their entries in
    `pillow_rgb_sha256.json`, with this function if `strip.jpg` changes."""
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        strip = decode_upload(f.read())
    grey = np.asarray(Image.fromarray(strip).convert("L"))
    level = (grey.astype(np.int32) * 16 // 256).astype(np.uint8)
    thunder = [b"".join(thunder_row(r) for r in level[y:y + 8])
               for y in range(0, 250, 8)]
    im = Image.fromarray(strip)
    return {
        "strip_lzma.tif": _zero_pad(save(im, compression="lzma",
                                         rowsperstrip=16, tiffinfo={317: 2})),
        "strip_zstd.tif": _zero_pad(save(im, compression="zstd",
                                         rowsperstrip=16)),
        "strip_rlew.tif": _zero_pad(rlew_by_pillow(grey < 160)),
        "strip_thunder.tif": _thunder_tiff(thunder, 2500, 8, height=250),
        "strip_ojpeg.tif": ojpeg_tables(strip),
    }


def _zero_pad(data: bytes) -> bytes:
    """libtiff's writer leaves the byte that word-aligns the directory
    after the last strip as its buffer held it: zeroed here, so the file
    is the same every time."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    im = Image.open(io.BytesIO(data))
    end = max(o + n for o, n in zip(im.tag_v2[273], im.tag_v2[279]))
    if end == ifd - 1:
        data = data[:end] + b"\0" + data[ifd:]
    return data


def test_committed_codec_fixtures():
    """The committed files are what `make_codec_fixtures` builds; Pillow's
    decode of each has the hash in `pillow_rgb_sha256.json`, and the
    port's equals it."""
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    for name, data in make_codec_fixtures().items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
        assert assert_same(data) == "decoded"
        rgb = pillow(data)
        assert list(rgb.shape) == hashes[name]["shape"]
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
            hashes[name]["rgb_sha256"]


def test_unported_tiff_codecs_still_refused(image):
    """SGILog and WebP-in-TIFF Pillow refuses here too; CIELAB is
    unsupported in the port."""
    for compression in (34676, 34677, 50001):
        data = build(_base_tags(8, 2, 8, 1, 1, compression,
                                {278: (3, [2])}), [bytes(16)])
        assert assert_same(data) == "refused"
    lab = build(_base_tags(8, 2, 8, 8, 3, 1, {278: (3, [2])}),
                [bytes(48)])
    pillow(lab)
    with pytest.raises(BadRequest, match="CIELAB"):
        decode_upload(lab)
