"""The port's PNM reader (`imdecode._decode_pnm`, through `decode_upload`)
against Pillow's `PpmImagePlugin`, which the JAX handler decodes uploads
with (`np.asarray(ImageOps.exif_transpose(Image.open(b)).convert("RGB"))`).
Pillow is the reference here only; the bar is bit equality, and a refusal
where Pillow refuses."""

import io

import numpy as np
import pytest
from PIL import Image, ImageOps

from ecgmm_torch.serve.imdecode import decode_image, decode_upload
from ecgmm_torch.serve.wire import BadRequest

BANDS = {b"P2": 1, b"P3": 3, b"P5": 1, b"P6": 3, b"P0CMYK": 4, b"PyP": 1,
         b"PyRGBA": 4, b"PyCMYK": 4}


def pillow(data: bytes) -> np.ndarray:
    return np.asarray(
        ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


def assert_same(data: bytes) -> str:
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
    np.testing.assert_array_equal(decode_image(data), want)
    return "decoded"


def samples(shape, maxval, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, maxval + 1, shape, dtype=np.int64)


def binary(magic: bytes, v: np.ndarray, maxval: int) -> bytes:
    h, w = v.shape[:2]
    body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    return magic + b"\n%d %d\n%d\n" % (w, h, maxval) + body


def plain(magic: bytes, v: np.ndarray, maxval: int, per_line=7) -> bytes:
    h, w = v.shape[:2]
    flat = [str(int(x)).encode() for x in v.reshape(-1)]
    lines = [b" ".join(flat[i:i + per_line])
             for i in range(0, len(flat), per_line)]
    return magic + b"\n# a comment\n%d %d\n%d\n" % (w, h, maxval) + \
        b"\n".join(lines) + b"\n"


@pytest.mark.parametrize("magic", [b"P2", b"P3", b"P5", b"P6", b"P0CMYK",
                                   b"PyP", b"PyRGBA", b"PyCMYK"])
@pytest.mark.parametrize("maxval", [1, 255, 256, 1000, 65535])
def test_every_magic_and_maxval(magic, maxval):
    """Binary samples unpacked as stored at maxval 255 (and grey at 65535
    as I;16B), else rescaled and rounded by Pillow's ppm decoder; the
    plain formats rounded by its plain decoder; grey above 255 as mode I,
    clipped at 255."""
    v = samples((13, 17, BANDS[magic]), maxval, seed=maxval)
    if magic in (b"P2", b"P3"):
        data = plain(magic, v, maxval)
    else:
        data = binary(magic, v, maxval)
    assert assert_same(data) == "decoded"


@pytest.mark.parametrize("width", [1, 7, 8, 9, 31])
def test_bitmaps(width):
    """P1 (plain, whitespace between digits optional, comments anywhere)
    and P4 (rows padded to a byte), 1 black."""
    bits = samples((5, width), 1, seed=width)
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    assert assert_same(b"P4\n%d 5\n" % width + rows.tobytes()) == "decoded"
    text = b"\n".join(b"".join(b"%d" % b for b in row) for row in bits)
    data = b"P1 %d 5 #c\n" % width + text[:3] + b"#x\r" + text[3:]
    assert assert_same(data) == "decoded"
    assert assert_same(b"P1 %d 5\n" % width + b" ".join(
        b"%d" % b for b in bits.reshape(-1))) == "decoded"


@pytest.mark.parametrize("scale", [b"-1.0", b"1.0", b"-0.25", b"3e2"])
def test_float_maps(scale):
    """Pf: bottom-up rows, little-endian for a negative scale, converted to
    RGB as Pillow converts F (truncated, clipped; NaN 0)."""
    rng = np.random.default_rng(1)
    f = rng.normal(120, 120, (9, 11)).astype(np.float32)
    f[0, :4] = [np.nan, np.inf, -np.inf, 255.9]
    order = "<f4" if scale.startswith(b"-") else ">f4"
    data = b"Pf\n11 9\n" + scale + b"\n" + f.astype(order).tobytes()
    assert assert_same(data) == "decoded"


def test_header_tokens_and_comments():
    """PpmImageFile._read_token: comments inside and between tokens, any
    whitespace, tokens of at most 10 bytes, integers as Python reads
    them."""
    v = samples((3, 4, 3), 255)
    body = v.astype(np.uint8).tobytes()
    for header in (b"P6 4 3 255\n", b"P6\t4\x0b3\x0c255\r", b"P6#c\n4 3 255 ",
                   b"P6 4#c\n 3 25#x\n5\n", b"P6 +4 3 255\n",
                   b"P6 4 3 00000000255\n", b"P6 4 3 2_55\n"):
        assert_same(header + body)
    for bad in (b"P6 4 3 256x\n", b"P6 4 3\n", b"P7 4 3 255\n",
                b"P6 0 3 255\n", b"P6 4 3 0\n", b"P6 4 3 65536\n",
                b"P6 4 -3 255\n", b"P6 4 3 000000000255\n", b"Pf 4 3 0\n",
                b"Pf 4 3 nan\n", b"P64 3 255\n"):
        assert assert_same(bad + body) == "refused"


def test_plain_samples_pillow_refuses():
    for data in (b"P2 2 1 10\n3 11", b"P2 2 1 10\n3 -1", b"P2 2 1 10\n3",
                 b"P2 2 1 10\n3 x", b"P2 2 1 10\n3 12345678901",
                 b"P1 2 1\n0 2", b"P3 1 1 255\n1 2"):
        assert assert_same(data) == "refused"
    # tokens past the image are not read; a bad byte in a bitmap's block is
    assert assert_same(b"P2 2 1 10\n3 4 x") == "decoded"
    assert assert_same(b"P1 2 1\n0 1 x") == "refused"


def test_plain_data_across_blocks():
    """A plain file of more than one 1 MiB block: tokens and comments cut
    by a block's edge are read whole."""
    v = samples((420, 600), 65535, seed=3)
    data = plain(b"P2", v, 65535, per_line=13)
    cut = data.index(b"\n", 1 << 20) - 3
    data = data[:cut] + b" #spans\n" + data[cut:]
    assert len(data) > 1 << 20
    assert assert_same(data) == "decoded"


def test_truncated_and_flipped():
    """Seeded cuts and single-bit flips of a file of each family."""
    files = [binary(b"P6", samples((6, 9, 3), 255), 255),
             binary(b"P5", samples((6, 9, 1), 1000), 1000),
             plain(b"P3", samples((4, 5, 3), 200), 200),
             b"P4 9 4\n" + bytes(range(1, 9)),
             b"Pf 3 2 -1\n" + np.arange(6, dtype="<f4").tobytes()]
    rng = np.random.default_rng(11)
    for data in files:
        assert assert_same(data) == "decoded"
        for _ in range(10):
            assert_same(data[:int(rng.integers(1, len(data)))])
            flipped = bytearray(data)
            flipped[int(rng.integers(0, len(data)))] ^= 1 << int(
                rng.integers(0, 8))
            assert_same(bytes(flipped))


def test_decompression_bomb():
    with pytest.raises(BadRequest, match="decompression bomb"):
        decode_upload(b"P6 40000 40000 255\n" + b"\0" * 64)
    with pytest.raises(Exception):
        pillow(b"P6 40000 40000 255\n" + b"\0" * 64)
