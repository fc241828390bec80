"""JPEG 2000 uploads (`ecgmm_torch/serve/jpeg2000.py` and
`native/j2kdec.cpp`, through `imdecode.decode_upload`) against Pillow 12.1
with openjpeg 2.5.4, which the JAX handler decodes uploads with. The bar
is `test_torch_tiff.py`'s `assert_same`: bit equality with
`np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`, or a
refusal where Pillow refuses.

Pillow's encoder makes the files: reversible and irreversible, JP2 and raw
codestreams, tiles with offsets, the five progressions, precincts,
code-block sizes, 1-7 resolutions, rate and dB layers, the colour
transform on and off, PLT and comments, modes L, LA, RGB, RGBA and I;16,
signed samples. What it never writes comes from openjpeg's own encoder,
the library Pillow bundles, driven through ctypes (`_opj_encode`: every
code-block style, SOP and EPH markers, progression order changes), or is
made here from those files: header fields edited (code-block styles,
wavelet, progression, precision, sign, subsampling, quantisation style,
colour space, ihdr, a palette, POC, RGN and Part 2 segments, tile-part
header segments, the JP2 boxes), tile-parts split and reordered, and
packets rewritten with SOP and EPH markers or with their headers moved
into PPT or PPM segments (`_packets` parses the packet headers of a
one-layer file). Tile-parts of unknown count over 4096 tiles decode in
linear time, as openjpeg decodes them. The committed fixtures' cuts and
flips are in `test_torch_jpeg2000_fuzz.py`."""

import hashlib
import io
import json
import os
import pathlib
import struct
import tempfile
import time

import numpy as np
import pytest
from PIL import Image

from ecgmm_torch import native
from ecgmm_torch.serve import jpeg2000
from ecgmm_torch.serve.imdecode import decode_upload
from ecgmm_torch.serve.wire import BadRequest
from tests.test_torch_tiff import FIXTURES, assert_same, pillow


@pytest.fixture(scope="module")
def image():
    """A 37x45 RGBA image: gradients, a flat band and noise."""
    rng = np.random.default_rng(19)
    y, x = np.mgrid[:37, :45]
    img = np.stack([x * 5, y * 6, (x + y) * 3, 255 - x * 4], axis=2)
    img = img + rng.integers(-20, 21, img.shape)
    img[12:17] = (20, 200, 90, 128)
    return np.clip(img, 0, 255).astype(np.uint8)


def saved(img, mode="RGB", **kwargs) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(img)
    if mode == "I;16":
        grey = img[..., 0].astype("<u2") * 257
        im = Image.frombytes("I;16", grey.shape[::-1], grey.tobytes())
    else:
        im = im.convert(mode)
    im.save(buf, "JPEG2000", **kwargs)
    return buf.getvalue()


def cases(data: bytes, seed: int, cuts: int, flips: int):
    rng = np.random.default_rng(seed)
    for _ in range(cuts):
        yield data[:int(rng.integers(0, len(data)))]
    for _ in range(flips):
        flipped = bytearray(data)
        at = int(rng.integers(0, len(data)))
        flipped[at] ^= 1 << int(rng.integers(0, 8))
        yield bytes(flipped)


def same(data: bytes) -> str:
    """`assert_same` for these uploads, which carry no orientation: a
    refusal of HTJ2K code-blocks by name stands for Pillow's decode."""
    try:
        want = pillow(data)
    except Exception:
        with pytest.raises(BadRequest):
            decode_upload(data)
        return "refused"
    try:
        got = decode_upload(data)
    except BadRequest as e:
        assert "HTJ2K" in str(e), e
        return "HTJ2K"
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "decoded"


# ---------------------------------------------------------------- encoder

GRID = [
    ("RGB", {}), ("RGB", {"irreversible": True}),
    ("RGB", {"no_jp2": True}), ("RGB", {"mct": 1}),
    ("RGB", {"irreversible": True, "mct": 1,
             "quality_layers": [40, 10, 2]}),
    ("RGB", {"quality_mode": "dB", "quality_layers": [30, 40, 50]}),
    ("RGB", {"tile_size": (16, 16)}),
    ("RGB", {"tile_size": (20, 12), "tile_offset": (2, 1),
             "offset": (3, 7), "irreversible": True}),
    ("RGB", {"precinct_size": (16, 16), "codeblock_size": (8, 16)}),
    ("RGB", {"codeblock_size": (4, 64), "irreversible": True}),
    ("RGB", {"plt": True, "comment": "a comment"}),
    ("L", {}), ("L", {"irreversible": True, "quality_layers": [20]}),
    ("LA", {}), ("LA", {"irreversible": True, "progression": "CPRL"}),
    ("RGBA", {}), ("RGBA", {"no_jp2": True, "irreversible": True,
                            "quality_layers": [30, 8]}),
    ("I;16", {}), ("I;16", {"irreversible": True, "no_jp2": True}),
    ("L", {"signed": True}), ("RGB", {"signed": True, "irreversible": True}),
    ("L", {"tile_size": (16, 20)}), ("LA", {"tile_size": (20, 16)}),
    ("I;16", {"tile_size": (16, 16), "tile_offset": (1, 2),
              "offset": (3, 3)}),
] + [("RGB", {"progression": p, "quality_layers": [30, 10, 3],
              "tile_size": (24, 20), "precinct_size": (16, 16),
              "irreversible": irr})
     for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
     for irr in (False, True)
     ] + [("RGB", {"num_resolutions": n, "no_jp2": n % 2 == 1})
          for n in range(1, 8)]


@pytest.mark.parametrize("mode, kwargs", GRID)
def test_written_by_pillow(image, mode, kwargs):
    if kwargs.get("num_resolutions", 0) == 7:
        # seven resolutions need a side of 64 or more
        image = np.tile(image, (2, 2, 1))
    assert assert_same(saved(image, mode, **kwargs)) == "decoded"


def test_no_exif_orientation(image):
    """Pillow's plugin sets no EXIF for a JPEG 2000 file, so
    `exif_transpose` leaves it as stored: `decode_upload` and
    `decode_image` agree."""
    data = saved(image)
    im = Image.open(io.BytesIO(data))
    assert dict(im.getexif()) == {}
    assert assert_same(data) == "decoded"


# ------------------------------------------------ openjpeg's own encoder


def _openjpeg():
    """Pillow's bundled libopenjp2, for its encoder: Pillow's writer sets
    no code-block style and no SOP or EPH marker, openjpeg's encoder
    does. Its parameter block is found by the defaults that
    `opj_set_default_encoder_parameters` writes (6 resolutions, 64x64
    code-blocks, style 0, reversible, no ROI component)."""
    import ctypes
    import glob

    import PIL
    import PIL.features  # noqa: F401  (loads Pillow's libraries)
    path, = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                   "pillow.libs", "libopenjp2*"))
    lib = ctypes.CDLL(path)
    v = ctypes.c_void_p
    for name, args, res in (
            ("opj_set_default_encoder_parameters", [v], None),
            ("opj_image_create", [ctypes.c_uint32, v, ctypes.c_int], v),
            ("opj_create_compress", [ctypes.c_int], v),
            ("opj_setup_encoder", [v, v, v], ctypes.c_int),
            ("opj_stream_create_default_file_stream",
             [ctypes.c_char_p, ctypes.c_int], v),
            ("opj_start_compress", [v, v, v], ctypes.c_int),
            ("opj_encode", [v, v], ctypes.c_int),
            ("opj_end_compress", [v, v], ctypes.c_int),
            ("opj_stream_destroy", [v], None),
            ("opj_destroy_codec", [v], None),
            ("opj_image_destroy", [v], None)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    return lib


def _opj_encode(img, tmp_path, *, style=0, csty=0, irreversible=False,
                rates=(0,), numres=3, cblk=(64, 64), pocs=(),
                tiles=None) -> bytes:
    """img (H, W, C) of 8-bit samples as a codestream from openjpeg's
    encoder with the given code-block style, Scod (2 SOP, 4 EPH),
    progression order changes (tile from 1, first resolution, first
    component, last layer, last resolution, last component, order) and
    tiles (width, height)."""
    import ctypes
    lib = _openjpeg()
    params = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_encoder_parameters(params)
    ints = np.frombuffer(params.raw, np.int32)
    at, = [i * 4 for i in range(len(ints) - 6)
           if list(ints[i:i + 6]) == [6, 64, 64, 0, 0, -1]]
    assert at == 5600  # the layout the offsets below are read from
    struct.pack_into("i", params, 20, 1)  # cp_disto_alloc
    if tiles:  # tile_size_on, then the tile size
        struct.pack_into("iiiii", params, 0, 1, 0, 0, *tiles)
    struct.pack_into("i", params, 48, csty)
    for i, (tile, r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        poc = 56 + 148 * i  # opj_poc_t: 148 bytes
        struct.pack_into("IIIII", params, poc, r0, c0, l1, r1, c1)
        struct.pack_into("ii", params, poc + 32, prg, prg)  # prg1, prg
        struct.pack_into("I", params, poc + 48, tile)
    struct.pack_into("I", params, 56 + 148 * 32, len(pocs))  # numpocs
    struct.pack_into("iiiii", params, at, numres, cblk[0], cblk[1], style,
                     int(irreversible))
    layers = at - 804  # tcp_numlayers, then 100 float rates
    struct.pack_into("i" + "f" * len(rates), params, layers, len(rates),
                     *rates)
    h, w, nc = img.shape
    comp = (ctypes.c_uint32 * (9 * nc))(*([1, 1, w, h, 0, 0, 8, 8, 0] * nc))
    image = lib.opj_image_create(nc, comp, 1 if nc >= 3 else 2)
    struct.pack_into("IIII", (ctypes.c_char * 16).from_address(image), 0,
                     0, 0, w, h)
    comps = ctypes.c_void_p.from_address(image + 24).value
    for c in range(nc):
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        np.ctypeslib.as_array((ctypes.c_int32 * (w * h)).from_address(
            data))[:] = img[..., c].reshape(-1)
    out = str(tmp_path / "opj.j2k").encode()
    codec = lib.opj_create_compress(0)
    stream = lib.opj_stream_create_default_file_stream(out, 0)
    ok = lib.opj_setup_encoder(codec, params, image) and \
        lib.opj_start_compress(codec, image, stream) and \
        lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream)
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(image)
    assert ok, "openjpeg's encoder failed"
    with open(out, "rb") as f:
        return f.read()


def test_code_block_styles_as_coded(image, tmp_path):
    """Every code-block style but HT, coded by openjpeg's encoder (BYPASS's
    raw passes, RESET, TERMALL's segments, VSC, PTERM, SEGSYM), half of
    them 9/7, a quarter with SOP and EPH markers: the same bytes as
    Pillow."""
    img = image[:24, :32, :3].astype(np.int32)
    for style in range(64):
        data = _opj_encode(img, tmp_path, style=style,
                           csty=6 if style % 4 == 0 else 0,
                           irreversible=(style * 37) % 64 < 32,
                           rates=(20, 6, 1), numres=4, cblk=(16, 16))
        cod = _seg(data, 0xFF52)
        assert data[cod + 12] == style
        assert same(data) == "decoded"


@pytest.mark.parametrize("pocs", [
    [(0, 0, 2, 2, 3, 0), (2, 0, 3, 4, 3, 2)],
    [(0, 0, 3, 4, 2, 4), (0, 2, 3, 4, 3, 1)],
    [(0, 0, 1, 4, 3, 3), (0, 0, 3, 4, 3, 0)]])
def test_progression_changes_as_coded(image, tmp_path, pocs):
    """POC segments as openjpeg's encoder writes them, in the main header
    and in each of four tiles' headers: packets already read are skipped
    when a later change covers them again."""
    img = np.ascontiguousarray(image[:, :40, :3]).astype(np.int32)
    whole = _opj_encode(img, tmp_path, pocs=[(1,) + p for p in pocs],
                        rates=(20, 8, 2), numres=4)
    tiled = _opj_encode(img, tmp_path, pocs=[(t,) + p for t in (1, 2, 3, 4)
                                             for p in pocs],
                        rates=(20, 8, 2), numres=4, tiles=(24, 20))
    for data in (whole, tiled):
        assert b"\xff\x5f" in data
        assert same(data) == "decoded"
    for case in cases(tiled, 70 + len(tiled) % 7, 40, 60):
        same(case)


# ---------------------------------------------------------------- edits


def _seg(data: bytes, marker: int) -> int:
    """The offset of the first `marker` segment of the main header, or
    of the first SOT where the main header ends."""
    at = data.index(b"\xff\x4f\xff\x51") + 2
    while True:
        m, n = struct.unpack_from(">HH", data, at)
        if m == marker:
            return at
        if m == 0xFF90:
            raise KeyError(marker)
        at += 2 + n


def _set(data: bytes, at: int, *values) -> bytes:
    out = bytearray(data)
    for i, v in enumerate(values):
        out[at + i] = v
    return bytes(out)


@pytest.mark.parametrize("base", ["rev", "irr", "tiled"])
def test_code_block_styles(image, base):
    """Every COD code-block style but HT (BYPASS, RESET, TERMALL, VSC,
    PTERM, SEGSYM and their combinations) read over data coded without
    them: the same coefficients, or the same refusal."""
    data = {"rev": saved(image, no_jp2=True),
            "irr": saved(image, irreversible=True, quality_layers=[20, 5]),
            "tiled": saved(image, tile_size=(16, 16), progression="RPCL",
                           codeblock_size=(8, 8))}[base]
    cod = _seg(data, 0xFF52)
    seen = set()
    for style in range(64):
        seen.add(same(_set(data, cod + 12, style)))
    assert seen == {"decoded", "refused"} or seen == {"decoded"}


@pytest.mark.parametrize("field", ["progression", "wavelet", "mct",
                                   "layers", "resolutions"])
def test_cod_fields(image, field):
    data = saved(image, irreversible=True, quality_layers=[30, 6],
                 tile_size=(24, 24), no_jp2=True)
    cod = _seg(data, 0xFF52)
    at, values = {"progression": (5, range(7)), "wavelet": (13, (0, 1, 2)),
                  "mct": (8, (0, 1, 2)), "layers": (7, (0, 1, 3)),
                  "resolutions": (9, (0, 1, 2, 5, 6, 33))}[field]
    for v in values:
        same(_set(data, cod + at, v))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_siz_precision_sign_and_subsampling(image, mode):
    """Each component's precision and sign, and its subsampling: Pillow
    guesses sYCC where the second or third of three or four components is
    the first subsampled one, and unpacks subsampled components at its
    own offsets."""
    data = saved(image, mode, no_jp2=True, tile_size=(32, 24))
    siz = _seg(data, 0xFF51)
    nc = struct.unpack_from(">H", data, siz + 38)[0]
    seen = set()
    for c in range(nc):
        for ssiz in (0x00, 0x03, 0x07, 0x08, 0x0B, 0x0F, 0x17, 0x1F, 0x87,
                     0x8B, 0x9F):
            seen.add(same(_set(data, siz + 40 + 3 * c, ssiz)))
        for dx, dy in ((2, 1), (1, 2), (2, 2), (3, 1), (4, 3), (0, 1)):
            seen.add(same(_set(data, siz + 41 + 3 * c, dx, dy)))
    assert "decoded" in seen


def test_quantisation_styles(image):
    """Sqcd: no quantisation, scalar derived, scalar expounded, the guard
    bits, and the styles openjpeg reads as expounded."""
    for kwargs in ({"no_jp2": True}, {"irreversible": True, "no_jp2": True}):
        data = saved(image, **kwargs)
        qcd = _seg(data, 0xFF5C)
        for sqcd in range(0, 256, 9):
            same(_set(data, qcd + 4, sqcd))


def _boxes(data: bytes):
    """The top-level boxes of a JP2 file: [(type, body)]."""
    out, at = [], 0
    while at < len(data):
        n, t = struct.unpack_from(">I4s", data, at)
        n = n or len(data) - at
        out.append((t, data[at + 8:at + n]))
        at += n
    return out


def _join(boxes) -> bytes:
    return b"".join(struct.pack(">I4s", 8 + len(b), t) + b for t, b in boxes)


def _with_jp2h(data: bytes, edit) -> bytes:
    """The file with its jp2h box's sub-boxes replaced by edit(sub-boxes)."""
    return _join([(t, _join(edit(_boxes(b))) if t == b"jp2h" else b)
                  for t, b in _boxes(data)])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_colour_spaces(image, mode):
    """colr: sRGB, grey, sYCC (Pillow's YCbCr conversion), e-sYCC, CMYK
    (mode CMYK only where Pillow's mode and openjpeg's space agree), CIELab,
    an ICC profile, no colr box, and a second colr box."""
    data = saved(image, mode)

    def colr(body):
        return lambda boxes: [(t, body if t == b"colr" else b)
                              for t, b in boxes]
    results = set()
    for enumcs in (16, 17, 18, 24, 12, 14, 3):
        results.add(same(_with_jp2h(data, colr(struct.pack(">BBBI", 1, 0, 0,
                                                           enumcs)))))
    results.add(same(_with_jp2h(data, colr(b"\x02\x00\x00icc!"))))
    results.add(same(_with_jp2h(data, colr(b"\x00\x00\x00"))))
    results.add(same(_with_jp2h(data, lambda boxes: [
        (t, b) for t, b in boxes if t != b"colr"])))
    results.add(same(_with_jp2h(data, lambda boxes: boxes + [
        (b"colr", struct.pack(">BBBI", 1, 0, 0, 12))])))
    assert results == {"decoded", "refused"}


@pytest.mark.parametrize("ihdr", [(1, 7), (1, 15), (2, 7), (3, 7), (4, 7)])
def test_ihdr_against_the_codestream(image, ihdr):
    """Pillow's mode comes from ihdr (components and depth), openjpeg's
    component count from SIZ: every pairing with every colour space
    picks Pillow's unpacker (grey to RGB or RGBA, sRGB with or without
    alpha, ...) or none."""
    nc, bpc = ihdr
    seen = set()
    for mode in ("L", "LA", "RGB", "RGBA"):
        data = saved(image, mode)
        for enumcs in (16, 17, 18, 12):
            def edit(boxes):
                out = []
                for t, b in boxes:
                    if t == b"ihdr":
                        b = b[:8] + struct.pack(">HB", nc, bpc) + b[11:]
                    if t == b"colr":
                        b = struct.pack(">BBBI", 1, 0, 0, enumcs)
                    out.append((t, b))
                return out
            seen.add(same(_with_jp2h(data, edit)))
    assert "decoded" in seen


def test_jp2_boxes(image):
    """The container as Pillow's BoxReader and openjpeg's box reader read
    it: XL and to-the-end lengths, JPX brands and rreq, unknown, uuid and
    xml boxes before and after the codestream, a res box, boxes inside
    jp2h out of order or of bad lengths, trailing bytes after EOC."""
    data = saved(image)
    boxes = _boxes(data)
    sig, ftyp, jp2h, jp2c = (b for _, b in boxes)

    def box(t, b, xl=False, zero=False):
        if xl:
            return struct.pack(">I4sQ", 1, t, 16 + len(b)) + b
        return struct.pack(">I4s", 0 if zero else 8 + len(b), t) + b

    def jp2h_with(sub):
        return box(b"jp2h", b"".join(sub))
    ihdr, colr = (box(t, b) for t, b in _boxes(jp2h))
    res = box(b"res ", box(b"resc", struct.pack(">HHHHBB", 1, 1, 1, 1, 0, 0)))
    head = box(b"jP  ", sig) + box(b"ftyp", ftyp)
    jpx = box(b"ftyp", b"jpx \0\0\0\0jpx jp2 ")
    variants = [
        head + box(b"jp2h", jp2h) + box(b"jp2c", jp2c, xl=True),
        head + box(b"jp2h", jp2h) + box(b"jp2c", jp2c, zero=True),
        head + box(b"jp2h", jp2h, xl=True) + box(b"jp2c", jp2c),
        head + box(b"jp2h", jp2h, zero=True) + box(b"jp2c", jp2c),
        box(b"jP  ", sig) + jpx + box(b"rreq", bytes(8)) +
        box(b"jp2h", jp2h) + box(b"jp2c", jp2c),
        head + box(b"uuid", bytes(20)) + box(b"jp2h", jp2h) +
        box(b"xml ", b"<x/>") + box(b"jp2c", jp2c) + box(b"uuid", bytes(9)),
        head + box(b"jp2h", jp2h) + box(b"jp2c", jp2c) + b"trailing",
        head + box(b"jp2h", jp2h) + box(b"jp2c", jp2c) + b"\0\0\0\x03xxxx",
        head + box(b"jp2h", jp2h) + box(b"jp2c", jp2c) + box(b"ftyp", ftyp),
        head + box(b"jp2h", jp2h) + box(b"jp2c", jp2c) +
        box(b"jp2h", jp2h_with([ihdr, box(b"pclr", bytes(6))])),
        head + jp2h_with([ihdr, colr, res]) + box(b"jp2c", jp2c),
        head + jp2h_with([colr, ihdr]) + box(b"jp2c", jp2c),
        head + jp2h_with([ihdr, ihdr, colr]) + box(b"jp2c", jp2c),
        head + jp2h_with([colr]) + box(b"jp2c", jp2c),
        head + jp2h_with([ihdr, colr, box(b"cdef", b"\0\0")]) +
        box(b"jp2c", jp2c),
        head + jp2h_with([ihdr, colr, box(b"bpcc", bytes(3))]) +
        box(b"jp2c", jp2c),
        head + jp2h_with([ihdr, colr[:-1]]) + box(b"jp2c", jp2c),
        head + jp2h_with([ihdr, box(b"colr", b"", zero=True)]) +
        box(b"jp2c", jp2c),
        head + box(b"colr", colr[8:]) + box(b"jp2h", jp2h) +
        box(b"jp2c", jp2c),
        head + box(b"jp2c", jp2c) + box(b"jp2h", jp2h),
        box(b"ftyp", ftyp) + head + box(b"jp2h", jp2h) + box(b"jp2c", jp2c),
        head + box(b"jp2h", jp2h),
    ]
    results = [same(v) for v in variants]
    assert results[0] == "decoded" and "refused" in results


def _pclr(entries, depths=(7, 7, 7)) -> bytes:
    """A pclr box body: entries of the given bit depths less one, each
    value in as many bytes as its depth needs."""
    body = struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
    return body + b"".join(
        v.to_bytes(((d & 0x7F) + 8) // 8, "big")
        for e in entries for v, d in zip(e, depths))


@pytest.mark.parametrize("mode", ["L", "LA"])
def test_injected_palette(image, mode):
    """A pclr box makes Pillow's mode P (PA): the indices through its own
    palette of distinct colours, the grey ramp past it; openjpeg leaves
    the indices as they are. P needs the sRGB space; a palette of more
    than 8 bits an entry keeps mode L; openjpeg's pclr and cmap rules."""
    data = saved(image, mode)
    rng = np.random.default_rng(5)
    entries = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(40)]
    entries[7] = entries[3]  # a repeated colour: Pillow keeps it once

    def palette(pclr, enumcs=16, extra=()):
        def edit(boxes):
            out = []
            for t, b in boxes:
                if t == b"colr":
                    b = struct.pack(">BBBI", 1, 0, 0, enumcs)
                out.append((t, b))
            return out + [(b"pclr", pclr)] + list(extra)
        return _with_jp2h(data, edit)
    assert same(palette(_pclr(entries))) == "decoded"
    assert same(palette(_pclr(entries), enumcs=17)) == "refused"
    assert same(palette(_pclr(entries, (15, 7, 7)))) == "refused"
    assert same(palette(_pclr(entries, (15, 7, 7)), enumcs=17)) == "decoded"
    assert same(palette(_pclr(entries[:2] + [(1,)]))) == "refused"
    same(palette(_pclr([(9, 8, 7, 6)] * 3, (7, 7, 7, 7))))
    same(palette(_pclr(entries), extra=[(b"cmap", bytes(12))]))
    same(palette(_pclr(entries), extra=[(b"cmap", bytes(4))]))
    same(palette(struct.pack(">HB", 0, 3) + bytes(3)))


def _main_header_with(data: bytes, segments) -> bytes:
    """The codestream with marker segments [(marker, body)] added at the
    end of its main header."""
    sot = _seg(data, 0xFF90)
    extra = b"".join(struct.pack(">HH", m, len(b) + 2) + b
                     for m, b in segments)
    return data[:sot] + extra + data[sot:]


def test_poc_rgn_and_other_segments(image):
    """POC (progression changes read over data written in another order),
    RGN (the ROI shift), CBD (precision and sign, not the level shift),
    MCO (every level shift zeroed), and the segments openjpeg checks and
    leaves: TLM, PLM, CRG, COM, MCT, MCC."""
    data = saved(image, irreversible=True, quality_layers=[20, 6],
                 no_jp2=True, num_resolutions=4)
    pocs = [
        [(0, 0, 2, 2, 3, 0), (2, 0, 2, 4, 3, 2)],
        [(0, 0, 1, 4, 3, 4), (0, 0, 2, 4, 3, 1)],
        [(0, 0, 2, 4, 3, 3)], [(0, 0, 2, 4, 3, 9)], [(3, 2, 2, 1, 1, 0)],
    ]
    for poc in pocs:
        body = b"".join(struct.pack(">BBHBBB", *p) for p in poc)
        same(_main_header_with(data, [(0xFF5F, body)]))
        same(_main_header_with(data, [(0xFF5F, body + b"\x00")]))
    for comp, shift in ((0, 0), (0, 3), (2, 9), (1, 30), (3, 1)):
        same(_main_header_with(data, [(0xFF5E, bytes([comp, 0, shift]))]))
    for segment in ((0xFF55, b"\x00\x50" + bytes(6)), (0xFF55, b"\x00"),
                    (0xFF57, b"\x00\x05"), (0xFF57, b""),
                    (0xFF63, bytes(12)), (0xFF63, bytes(8)),
                    (0xFF64, b"\x00\x01hello"), (0xFF78, b"\x00\x03\x07\x07"
                                                         b"\x87"),
                    (0xFF78, b"\x00\x02\x07\x07"),
                    (0xFF74, b"\x00\x00\x00\x00\x00\x00\x01\x02"),
                    (0xFF74, b"\x00\x00\x00"), (0xFF77, b"\x00"),
                    (0xFF77, b"\x01"), (0xFF77, b"\x02\x00\x01"),
                    (0xFF75, bytes(7)), (0xFF75, bytes(3))):
        same(_main_header_with(data, [segment]))


def test_htj2k_refused_by_name(image):
    """A COD whose code-block style has the HT bit: openjpeg would decode
    HTJ2K code-blocks; the port refuses them as unsupported, naming
    them."""
    data = saved(image, no_jp2=True)
    cod = _seg(data, 0xFF52)
    for style in (0x40, 0x48):
        with pytest.raises(BadRequest, match="HTJ2K"):
            decode_upload(_set(data, cod + 12, style))
    assert same(_set(data, cod + 12, 0xC0)) == "refused"  # mixed HT


# ------------------------------------------------------------ tile-parts


def _tile_parts(data: bytes):
    """(main header, [(tile, tile-part header segments, data)])."""
    at = _seg(data, 0xFF90)
    head, parts = data[:at], []
    while data[at:at + 2] == b"\xff\x90":
        _, _, tile, psot, _, _ = struct.unpack_from(">HHHIBB", data, at)
        end = at + psot
        body = data[at + 12:end]
        sod = body.index(b"\xff\x93")
        parts.append((tile, body[:sod], body[sod + 2:]))
        at = end
    return head, parts


def _codestream(head, parts, tail=b"\xff\xd9", last_psot_zero=False):
    """parts: [(tile, part index, count, header segments, data)]."""
    out = bytearray(head)
    for i, (tile, tp, tn, segs, body) in enumerate(parts):
        psot = 12 + len(segs) + 2 + len(body)
        if last_psot_zero and i == len(parts) - 1:
            psot = 0
        out += struct.pack(">HHHIBB", 0xFF90, 10, tile, psot, tp, tn)
        out += segs + b"\xff\x93" + body
    return bytes(out + tail)


@pytest.mark.parametrize("count", ["known", "unknown", "last_psot_zero"])
def test_tile_parts_split_and_interleaved(image, count):
    """Each tile's data split in two tile-parts, the first parts of every
    tile before the second ones: openjpeg decodes a tile when its last
    part is read (TNsot given), at EOC otherwise; a last tile-part of
    Psot 0 runs to the end of the codestream."""
    data = saved(image, no_jp2=True, tile_size=(16, 16),
                 quality_layers=[20, 4], irreversible=True)
    head, parts = _tile_parts(data)
    tn = 0 if count == "unknown" else 2
    split = [(t, 0, tn, segs, body[:len(body) // 2]) for t, segs, body in
             parts]
    split += [(t, 1, tn, b"", body[len(body) // 2:]) for t, _, body in parts]
    made = _codestream(head, split, last_psot_zero=count == "last_psot_zero")
    assert same(made) == "decoded"
    np.testing.assert_array_equal(decode_upload(made), pillow(data))
    for seed, case in enumerate(cases(made, 40, 60, 60)):
        same(case)
    # out of order, and a missing EOC
    assert same(_codestream(head, split[::-1])) == "refused"
    same(_codestream(head, split, tail=b""))


def test_many_tiles_of_unknown_tile_part_count(image):
    """4096 tiles whose tile-parts all give TNsot 0: openjpeg decodes them
    only at EOC, moving one cursor forward over the tiles, so the decode
    takes time linear in the tiles. The port's, bit-equal to Pillow's,
    takes no more than four times Pillow's (best of two each)."""
    rng = np.random.default_rng(4096)
    noise = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    data = bytearray(saved(noise, no_jp2=True, tile_size=(4, 4),
                           num_resolutions=2))
    head, parts = _tile_parts(bytes(data))
    assert len(parts) == 4096
    at = len(head)
    while data[at:at + 2] == b"\xff\x90":
        data[at + 11] = 0
        at += struct.unpack_from(">I", data, at + 6)[0]
    data = bytes(data)
    times = {"pillow": [], "port": []}
    for _ in range(2):
        for who, decode in (("pillow", pillow), ("port", decode_upload)):
            t = time.perf_counter()
            got = decode(data)
            times[who].append(time.perf_counter() - t)
        np.testing.assert_array_equal(got, pillow(data))
    assert min(times["port"]) <= 4 * min(times["pillow"]), times


def test_tile_part_header_segments(image):
    """Segments in a tile-part header override the main header's for that
    tile (COD, COC, QCD, QCC, RGN, POC, COM, PPT), and those allowed only
    in the main header, or unknown there, refuse the file."""
    data = saved(image, no_jp2=True, tile_size=(24, 24), irreversible=True,
                 quality_layers=[24, 6])
    head, parts = _tile_parts(data)
    cod_at = _seg(head, 0xFF52)
    cod = head[cod_at + 4:cod_at + 2 + struct.unpack_from(">H", head,
                                                           cod_at + 2)[0]]
    qcd_at = _seg(head, 0xFF5C)
    qcd = head[qcd_at + 4:qcd_at + 2 + struct.unpack_from(">H", head,
                                                           qcd_at + 2)[0]]
    extras = [
        (0xFF52, cod[:8] + bytes([0x18]) + cod[9:]),  # VSC, PTERM
        (0xFF52, cod[:5] + bytes([3]) + cod[6:]),     # fewer resolutions
        (0xFF52, cod[:9] + bytes([1]) + cod[10:]),    # the 5/3 wavelet
        (0xFF53, bytes([1, 0]) + cod[5:]),            # COC, component 1
        (0xFF5C, bytes([qcd[0] ^ 0x20]) + qcd[1:]),   # guard bits
        (0xFF5D, bytes([2]) + qcd),                   # QCC, component 2
        (0xFF5E, bytes([0, 0, 4])),                   # RGN
        (0xFF5F, struct.pack(">BBHBBB", 0, 0, 2, 6, 3, 1)),  # POC
        (0xFF64, b"\x00\x01tile comment"),
        (0xFF55, b"\x00\x50" + bytes(6)),             # TLM: main only
        (0xFF72, b"\x00\x00"),                        # unknown
    ]
    results = set()
    for marker, body in extras:
        segment = struct.pack(">HH", marker, len(body) + 2) + body
        for tile in (0, 1):
            made = _codestream(head, [
                (t, 0, 1, segs + segment if t == tile else segs, b)
                for t, segs, b in parts])
            results.add(same(made))
    assert results == {"decoded", "refused"}


# ---------------------------------------------------------------- packets


class _Bits:
    """openjpeg's packet header bit reader (a 0 bit stuffed after 0xFF)."""

    def __init__(self, data: bytes, at: int):
        self.data, self.at, self.buf, self.ct = data, at, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.at < len(self.data):
                self.buf |= self.data[self.at]
                self.at += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self.bit()
        self.ct = 0


def _packets(body: bytes, counts):
    """The packets of a one-layer tile whose every band is one code-block,
    as [(header, data)]: counts holds each packet's number of bands."""
    out, at = [], 0
    for nbands in counts:
        b = _Bits(body, at)
        lengths = []
        if b.bit():
            for _ in range(nbands):
                if not b.bit():  # inclusion (a one-node tag tree)
                    continue
                while not b.bit():  # zero bit-planes
                    pass
                passes = 1
                if b.bit():
                    passes = 2
                    if b.bit():
                        n = b.bits(2)
                        passes = 3 + n
                        if n == 3:
                            n = b.bits(5)
                            passes = 6 + n
                            if n == 31:
                                passes = 37 + b.bits(7)
                lblock = 3
                while b.bit():
                    lblock += 1
                lengths.append(b.bits(lblock + passes.bit_length() - 1))
        b.align()
        end = b.at + sum(lengths)
        out.append((body[at:b.at], body[b.at:end]))
        at = end
    assert at == len(body)
    return out


@pytest.mark.parametrize("form", ["sop_eph", "ppt", "ppm"])
@pytest.mark.parametrize("tiles", [1, 4])
def test_rewritten_packets(image, form, tiles):
    """The packets of an LRCP file (one tile, or four) rewritten: each
    with an SOP marker before it and an EPH marker after its header (Scod
    bits 1 and 2), or every header of a tile moved into two PPT segments
    of its tile-part header, or into PPM segments of the main header, one
    Nppm a tile-part, their data running on from one segment to the next
    and from one tile to the next. The same image as the file they came
    from; then cuts and flips of it."""
    img = np.ascontiguousarray(image[:32, :32, :3])
    kwargs = {"tile_size": (16, 16)} if tiles == 4 else {}
    data = saved(img, no_jp2=True, num_resolutions=3, **kwargs)
    head, parts = _tile_parts(data)
    assert len(parts) == tiles
    made_parts, ppm = [], b""
    for tile, segs, body in parts:
        packets = _packets(body, [1, 1, 1, 3, 3, 3, 3, 3, 3])
        headers = b"".join(h for h, _ in packets)
        if form == "sop_eph":
            body = b"".join(struct.pack(">HHH", 0xFF91, 4, i) + h +
                            b"\xff\x92" + d
                            for i, (h, d) in enumerate(packets))
        else:
            body = b"".join(d for _, d in packets)
        if form == "ppt":
            half = len(headers) // 2
            segs += b"".join(struct.pack(">HHB", 0xFF61, len(h) + 3, z) + h
                             for z, h in ((0, headers[:half]),
                                          (1, headers[half:])))
        ppm += struct.pack(">I", len(headers)) + headers
        made_parts.append((tile, 0, 1, segs, body))
    if form == "sop_eph":
        cod = _seg(head, 0xFF52)
        head = _set(head, cod + 4, head[cod + 4] | 6)
    elif form == "ppm":
        cut = [0, 6, len(ppm) // 2, len(ppm)]  # a segment ends inside data
        head = _main_header_with(head + b"\xff\x90\x00\x0a", [
            (0xFF60, bytes([z]) + ppm[cut[z]:cut[z + 1]])
            for z in range(3)])[:-4]
    made = _codestream(head, made_parts)
    assert same(made) == "decoded"
    np.testing.assert_array_equal(decode_upload(made), pillow(data))
    for case in cases(made, 50 + len(form) + tiles, 60, 90):
        same(case)


# ---------------------------------------------------------------- units


def test_mq_decoder_on_the_t88_test_sequence():
    """The MQ decoder on the test sequence of ITU-T T.88 Annex H.2 (the
    same coder as JPEG 2000's): 256 decisions of one context from state
    0, coded in 30 bytes."""
    coded = bytes.fromhex("84C73BFCE1A14304022000 00410DBB86F4317FFF88"
                          "FF37471ADB6ADFFFAC".replace(" ", ""))
    decisions = bytes.fromhex("00020051000000C00352872AAAAAAAAA82C02000FC"
                              "D79EF6BF7FED904F46A3BF")
    out = np.zeros(256, np.uint8)
    assert native.library().ecgmm_j2k_mq_decode(coded, len(coded), 256, 0,
                                                out.ctypes.data) == 0
    assert np.packbits(out).tobytes() == decisions


def _forward53(x: np.ndarray, cas: int):
    """The reversible 5/3 analysis of a line whose first sample lies on
    an odd coordinate where cas is 1 (symmetric extension), in exact
    integer arithmetic: (low-pass, high-pass)."""
    n = len(x)
    if n == 1:
        return (x.copy(), x[:0]) if cas == 0 else (x[:0], 2 * x)
    y = x.astype(np.int64).copy()

    def at(v, i):
        return v[i] if 0 <= i < n else v[2 * (n - 1) - i if i >= n else -i]
    for i in range(1 - cas, n, 2):
        y[i] = x[i] - (int(at(x, i - 1)) + int(at(x, i + 1))) // 2
    for i in range(cas, n, 2):
        y[i] = x[i] + (int(at(y, i - 1)) + int(at(y, i + 1)) + 2) // 4
    return y[cas::2], y[1 - cas::2]


def test_inverse_53_against_exact_lifting():
    """The inverse 5/3 of a line gives back every line's samples from its
    exact integer analysis, for both phases and lengths 1-40."""
    lib = native.library()
    rng = np.random.default_rng(7)
    for n in range(1, 41):
        for cas in (0, 1):
            x = rng.integers(-5000, 5000, n).astype(np.int32)
            lo, hi = _forward53(x, cas)
            line = np.concatenate([lo, hi]).astype(np.int32)
            assert lib.ecgmm_j2k_idwt53_line(line.ctypes.data, len(lo),
                                             len(hi), cas) == 0
            np.testing.assert_array_equal(line, x)


# ---------------------------------------------------------------- fixtures


# the strips' codings: three reversible layers, and three irreversible
# ones with the colour transform (ICT), each at rates 40, 20 and 10
_STRIP_CODINGS = {
    "strip_layers.jp2": {"quality_layers": [40, 20, 10]},
    "strip_97.jp2": {"quality_layers": [40, 20, 10], "irreversible": True,
                     "mct": 1},
}


def _strip() -> np.ndarray:
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        return decode_upload(f.read())


def _save(im, **kwargs) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kwargs)
    return buf.getvalue()


def make_jpeg2000_fixtures() -> dict:
    """The fixtures `chip_smoke.py` decodes on the card, built from the
    committed `strip.jpg` (decoded by the port): the 250x2500 strip as a
    JP2 in each of `_STRIP_CODINGS`; the 48x72 crop
    strip[88:136, 600:672] as a tiled PCRL codestream (32x24 tiles, tile
    and image offsets, 32x32 precincts, 16x16 code-blocks); the 96x144
    crop strip[70:166, 600:744] as a 9/7 codestream of two layers coded
    by openjpeg's encoder with the code-block style BYPASS, RESET, VSC,
    PTERM and SEGSYM and with SOP and EPH markers; and that
    crop's grey with a horizontal alpha ramp as an LA JP2 (9/7, RLCP, three
    layers). Regenerate them, and their entries in
    `pillow_rgb_sha256.json`, with this function if `strip.jpg` changes."""
    strip = _strip()
    crop = np.ascontiguousarray(strip[70:166, 600:744])
    with tempfile.TemporaryDirectory() as tmp:
        styled = _opj_encode(crop.astype(np.int32), pathlib.Path(tmp),
                             style=0x3B, csty=6, irreversible=True,
                             rates=(30, 12), numres=4, cblk=(32, 16))
    grey = np.asarray(Image.fromarray(crop).convert("L"))
    ramp = np.repeat((np.arange(144) * 255 // 143)[None, :].astype(np.uint8),
                     96, axis=0)
    made = {name: _save(Image.fromarray(strip), **coding)
            for name, coding in _STRIP_CODINGS.items()}
    return {
        **made,
        "crop_pcrl_tiled.j2k": _save(
            Image.fromarray(np.ascontiguousarray(strip[88:136, 600:672])),
            no_jp2=True, tile_size=(32, 24), tile_offset=(5, 3),
            offset=(9, 7), progression="PCRL", precinct_size=(32, 32),
            codeblock_size=(16, 16)),
        "crop_97_styles.j2k": styled,
        "crop_la.jp2": _save(Image.fromarray(np.stack([grey, ramp], 2)),
                            progression="RLCP", quality_layers=[20, 8, 2],
                            irreversible=True),
    }


_FUZZ = [("crop_pcrl_tiled.j2k", 500, 500), ("crop_97_styles.j2k", 500, 500),
         ("crop_la.jp2", 500, 500), ("strip_layers.jp2", 500, 8),
         ("strip_97.jp2", 500, 8)]


def test_committed_jpeg2000_fixtures():
    """The committed files are what `make_jpeg2000_fixtures` builds;
    Pillow's decode of each has the hash in `pillow_rgb_sha256.json`, and
    the port's equals it."""
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    made = make_jpeg2000_fixtures()
    assert sum(len(d) for d in made.values()) < 500_000
    for name, data in made.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
        assert same(data) == "decoded"
        rgb = pillow(data)
        assert list(rgb.shape) == hashes[name]["shape"]
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
            hashes[name]["rgb_sha256"]
    assert {name for name, _, _ in _FUZZ} == set(made)


def test_table_entry_is_the_decoder():
    from ecgmm_torch.serve import rasters
    entry = dict((n, o) for n, _, o in rasters.PLUGINS)["JPEG2000"]
    assert entry is jpeg2000.decode_jpeg2000
