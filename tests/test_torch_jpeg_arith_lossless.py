"""Arithmetic-coded (SOF9, SOF10), lossless (SOF3) and block-smoothed
progressive JPEG through the port's upload decoder
(`ecgmm_torch.serve.imdecode`, C++ in `native/jpegscan.cpp` and
`native/imdecode.cpp`) against Pillow 12.1,
bit for bit, as `decode_upload` (EXIF turn) and `decode_image` (none);
and every JPEG coding, Huffman's too, cut and corrupted, decoded or
refused as Pillow decodes or refuses it.

Pillow cannot write these files. A small C program (`ENCODER_C`, built
once a session with gcc into a temporary directory) drives the encoder
of the libjpeg-turbo that Pillow bundles (`pillow.libs/libjpeg-*.so`),
through the libjpeg 6.2 API of the system's `jpeglib.h`: arithmetic
coding with DAC conditioning, simple or scripted progression, restart
intervals, and `jpeg_enable_lossless`. If it cannot be built, the tests
fail.

`make_jpeg_fixtures` builds the files committed under
`ecgmm_torch/serve/fixtures/` that `chip_smoke.py` decodes where Pillow
is absent."""

import glob
import hashlib
import io
import json
import os
import struct
import subprocess

import numpy as np
import pytest
from PIL import Image, ImageOps

import PIL
from ecgmm_torch import native
from ecgmm_torch.serve.imdecode import decode_image, decode_upload
from ecgmm_torch.serve.wire import BadRequest

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ecgmm_torch", "serve", "fixtures")

ENCODER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int psv, int pt);

static jpeg_scan_info scans[64];

/* jenc W H C key=value ... < pixels > file.jpg */
int main(int argc, char** argv) {
  int w = atoi(argv[1]), h = atoi(argv[2]), nc = atoi(argv[3]);
  size_t n = (size_t)w * h * nc;
  unsigned char* px = malloc(n);
  if (fread(px, 1, n, stdin) != n) return 2;
  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr err;
  ci.err = jpeg_std_error(&err);
  jpeg_create_compress(&ci);
  unsigned char* out = NULL;
  unsigned long outsize = 0;
  jpeg_mem_dest(&ci, &out, &outsize);
  ci.image_width = w;
  ci.image_height = h;
  ci.input_components = nc;
  ci.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&ci);
  for (int a = 4; a < argc; ++a) {
    char* k = argv[a];
    char* v = strchr(k, '=');
    *v++ = 0;
    if (!strcmp(k, "q")) {
      jpeg_set_quality(&ci, atoi(v), TRUE);
    } else if (!strcmp(k, "arith")) {
      ci.arith_code = atoi(v);
    } else if (!strcmp(k, "prog")) {
      jpeg_simple_progression(&ci);
    } else if (!strcmp(k, "restart")) {
      ci.restart_interval = atoi(v);
    } else if (!strcmp(k, "rows")) {
      ci.restart_in_rows = atoi(v);
    } else if (!strcmp(k, "samp")) { /* 2x2,1x1,1x1 */
      for (int c = 0; c < ci.num_components && *v; ++c) {
        ci.comp_info[c].h_samp_factor = v[0] - '0';
        ci.comp_info[c].v_samp_factor = v[2] - '0';
        v += v[3] == ',' ? 4 : 3;
      }
    } else if (!strcmp(k, "dac")) { /* table,L,U,Kx */
      int t, L, U, K;
      sscanf(v, "%d,%d,%d,%d", &t, &L, &U, &K);
      ci.arith_dc_L[t] = L;
      ci.arith_dc_U[t] = U;
      ci.arith_ac_K[t] = K;
    } else if (!strcmp(k, "lossless")) { /* predictor,point transform */
      int psv, pt;
      sscanf(v, "%d,%d", &psv, &pt);
      jpeg_enable_lossless(&ci, psv, pt);
    } else if (!strcmp(k, "scans")) { /* comps:Ss:Se:Ah:Al;... */
      int ns = 0;
      for (char* s = strtok(v, ";"); s; s = strtok(NULL, ";")) {
        char comps[8];
        int ss, se, ah, al;
        sscanf(s, "%7[0-9]:%d:%d:%d:%d", comps, &ss, &se, &ah, &al);
        jpeg_scan_info* si = &scans[ns++];
        si->comps_in_scan = (int)strlen(comps);
        for (int c = 0; c < si->comps_in_scan; ++c)
          si->component_index[c] = comps[c] - '0';
        si->Ss = ss;
        si->Se = se;
        si->Ah = ah;
        si->Al = al;
      }
      ci.scan_info = scans;
      ci.num_scans = ns;
    } else {
      fprintf(stderr, "unknown option %s\n", k);
      return 2;
    }
  }
  jpeg_start_compress(&ci, TRUE);
  while (ci.next_scanline < ci.image_height) {
    JSAMPROW row = px + (size_t)ci.next_scanline * w * nc;
    jpeg_write_scanlines(&ci, &row, 1);
  }
  jpeg_finish_compress(&ci);
  fwrite(out, 1, outsize, stdout);
  jpeg_destroy_compress(&ci);
  return 0;
}
"""


def _pillow_libjpeg() -> str:
    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                   "pillow.libs", "libjpeg-*.so*"))
    assert found, "Pillow's bundled libjpeg-turbo is not where it should be"
    return os.path.realpath(found[0])


@pytest.fixture(scope="session")
def jenc(tmp_path_factory):
    """The encoder helper, built once a session (failing, not skipping,
    where it cannot be built)."""
    lib = _pillow_libjpeg()
    exe = str(tmp_path_factory.mktemp("jenc") / "jenc")
    out = subprocess.run(
        ["gcc", "-O1", "-x", "c", "-", "-x", "none", lib, "-o", exe,
         f"-Wl,-rpath,{os.path.dirname(lib)}"],
        input=ENCODER_C.encode(), capture_output=True)
    assert out.returncode == 0, out.stderr.decode(errors="replace")[-2000:]
    return exe


def encode(jenc, img: np.ndarray, *opts: str) -> bytes:
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    out = subprocess.run([jenc, str(w), str(h), str(c), *opts],
                         input=img.tobytes(), capture_output=True)
    assert out.returncode == 0, out.stderr.decode()
    return out.stdout


def image(h: int, w: int, seed: int = 0, channels: int = 3) -> np.ndarray:
    """Gradients with noise, so that every coefficient band carries data."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 5 + x // 3) % 256,
                     ((x + y) * 2) % 256, (x * y) % 256][:channels], -1)
    noise = rng.integers(-20, 21, (h, w, channels))
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    return img[:, :, 0] if channels == 1 else img


def pillow(data: bytes, turn: bool = True):
    """Pillow's RGB decode (EXIF-turned with `turn`), or None where it
    refuses the file."""
    try:
        im = Image.open(io.BytesIO(data))
        if turn:
            im = ImageOps.exif_transpose(im)
        return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of Pillow's counts
        return None


def port(data: bytes, turn: bool = True):
    try:
        return (decode_upload if turn else decode_image)(data)
    except BadRequest:
        return None


def assert_same_as_pillow(data: bytes, refused: bool = False):
    """decode_upload and decode_image bit-equal to Pillow's, or both
    refusing (`refused` says which is expected)."""
    for turn in (True, False):
        want, got = pillow(data, turn), port(data, turn)
        if refused:
            assert want is None and got is None
            continue
        assert want is not None
        assert got is not None and got.dtype == np.uint8
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def agree_with_pillow(data: bytes) -> bool:
    want, got = pillow(data), port(data)
    if want is None or got is None:
        return want is None and got is None
    return want.shape == got.shape and np.array_equal(want, got)


def segments(data: bytes):
    """[(marker, offset of its 0xFF, offset after its segment)], the
    entropy-coded data skipped, up to EOI."""
    out, pos = [], 2
    while pos < len(data) - 1:
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) or \
                0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append((marker, pos, pos + 2))
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((marker, pos, pos + 2 + length))
        pos += 2 + length
    return out


def without(data: bytes, marker: int) -> bytes:
    """The file with every `marker` segment taken out."""
    out, last = b"", 0
    for m, start, end in segments(data):
        if m == marker:
            out += data[last:start]
            last = end
    return out + data[last:]


def with_segment(data: bytes, marker: int, body: bytes,
                 before: int = None) -> bytes:
    """A segment inserted after SOI, or before the marker at `before`."""
    at = 2 if before is None else before
    return data[:at] + struct.pack(">BBH", 0xFF, marker, len(body) + 2) \
        + body + data[at:]


def sof_patched(data: bytes, sampling=None, ids=None) -> bytes:
    """The frame header's sampling factors ("hxv" each) or component ids
    rewritten (the scan headers' ids with them)."""
    b = bytearray(data)
    segs = segments(data)
    sof = next(s for s in segs if s[0] in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9,
                                           0xCA))[1]
    nf = b[sof + 9]
    old = [b[sof + 10 + 3 * c] for c in range(nf)]
    for c in range(nf):
        o = sof + 10 + 3 * c
        if sampling:
            b[o + 1] = int(sampling[c][0]) << 4 | int(sampling[c][2])
        if ids:
            b[o] = ids[c]
    if ids:
        for m, start, _ in segs:
            if m == 0xDA:
                for j in range(b[start + 4]):
                    b[start + 5 + 2 * j] = ids[old.index(b[start + 5 + 2 * j])]
    return bytes(b)


def with_orientation(data: bytes, orientation: int) -> bytes:
    ex = Image.Exif()
    ex[0x0112] = orientation
    return with_segment(data, 0xE1, ex.tobytes())


def first_scans(data: bytes, n: int) -> bytes:
    """A progressive JPEG cut after its first n scans, ended with EOI."""
    pos = 0
    for _ in range(n + 1):
        pos = data.index(b"\xff\xda", pos + 2)
    return data[:pos] + b"\xff\xd9"


def pillow_jpeg(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


SAMPLINGS = {"gray": None, "4:4:4": "1x1,1x1,1x1", "4:2:0": "2x2,1x1,1x1",
             "4:2:2": "2x1,1x1,1x1"}


def _arith_file(jenc, mode, sampling, restart, dac, hw=(37, 53), seed=0):
    img = image(*hw, seed=seed, channels=1 if sampling == "gray" else 3)
    opts = ["arith=1"] + (["prog=1"] if mode == "progressive" else [])
    if SAMPLINGS[sampling]:
        opts.append("samp=" + SAMPLINGS[sampling])
    if restart:
        opts.append(f"restart={restart}")
    if dac:
        opts += ["dac=0,2,6,9", "dac=1,1,3,2"]
    return encode(jenc, img, *opts)


# ------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("dac", [False, True], ids=["nodac", "dac"])
@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_arithmetic_bit_equal_to_pillow(jenc, mode, sampling, restart, dac):
    """SOF9 and SOF10 at gray, 4:4:4, 4:2:0 and 4:2:2 (odd sizes), with and
    without restart markers; "dac" sets other conditioning bounds (L, U,
    Kx) than the defaults, "nodac" takes every DAC segment out (libjpeg
    writes one before each scan), leaving the defaults."""
    data = _arith_file(jenc, mode, sampling, restart, dac)
    assert (b"\xff\xc9" if mode == "sequential" else b"\xff\xca") in data
    if not dac:
        data = without(data, 0xCC)
        assert b"\xff\xcc" not in data[:data.index(b"\xff\xda")]
    assert_same_as_pillow(data)


def test_qm_table_is_libjpegs():
    """The QM coder's probability table (T.81 Table D.2 in jaricom.c's
    packing) equals the `jpeg_aritab` that Pillow's libjpeg exports."""
    import ctypes

    mine = np.zeros(114, np.int32)
    native.library().ecgmm_jpeg_aritab(mine.ctypes.data)
    theirs = (ctypes.c_long * 114).in_dll(ctypes.CDLL(_pillow_libjpeg()),
                                         "jpeg_aritab")
    np.testing.assert_array_equal(mine, np.array(theirs))


# --------------------------------------------------------------- lossless


@pytest.mark.parametrize("components", [1, 3])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_bit_equal_to_pillow(jenc, psv, pt, components):
    """SOF3 with each predictor and point transforms 0 and 2, gray and
    RGB (libjpeg-turbo writes RGB with an Adobe marker, transform 0)."""
    img = image(41, 29, seed=psv, channels=components)
    data = encode(jenc, img, f"lossless={psv},{pt}")
    assert b"\xff\xc3" in data
    assert_same_as_pillow(data)
    if pt == 0:  # lossless: the samples themselves
        want = img if components == 3 else np.repeat(img[:, :, None], 3, 2)
        np.testing.assert_array_equal(decode_image(data), want)


def _lossless_layout(jenc, case):
    rgb = image(37, 43, seed=3)
    data = encode(jenc, rgb, "lossless=4,0")
    if case == "restart rows":
        return encode(jenc, rgb, "lossless=5,1", "rows=2"), False
    if case == "separate scans":
        return encode(jenc, rgb, "lossless=6,0",
                      "scans=0:1:0:0:0;1:1:0:0:0;2:1:0:0:0"), False
    if case in ("4:2:0", "4:2:2", "4x1", "gray 2x2"):
        # the encoder writes full-size components only: relabelling the
        # sampling factors makes libjpeg read the same data with those
        # MCUs (fewer chroma samples, dummy ones at the odd edges)
        if case == "gray 2x2":
            return sof_patched(encode(jenc, rgb[:, :, 1], "lossless=2,0"),
                               sampling=["2x2"]), False
        sampling = {"4:2:0": ["2x2", "1x1", "1x1"],
                    "4:2:2": ["2x1", "1x1", "1x1"],
                    "4x1": ["4x1", "1x1", "1x1"]}[case]
        return sof_patched(data, sampling=sampling), False
    if case == "ids 1,2,3 no Adobe":  # libjpeg takes it as RGB when lossless
        return sof_patched(without(data, 0xEE), ids=[1, 2, 3]), False
    if case == "CMYK":
        return encode(jenc, image(37, 43, seed=4, channels=4),
                      "lossless=1,0"), False
    if case == "JFIF (YCbCr)":  # no colour conversion in lossless mode
        return with_segment(data, 0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                            b"\x01\x00\x00"), True
    if case == "Adobe YCCK":
        cmyk = bytearray(encode(jenc, image(37, 43, seed=4, channels=4),
                                "lossless=1,0"))
        cmyk[cmyk.index(b"Adobe") + 11] = 2
        return bytes(cmyk), True
    if case == "restart not a row":  # libjpeg-turbo refuses it
        b = bytearray(encode(jenc, rgb, "lossless=1,0", "rows=1"))
        i = b.index(b"\xff\xdd")
        b[i + 4:i + 6] = struct.pack(">H", 7)
        return bytes(b), True
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "restart rows", "separate scans", "4:2:0", "4:2:2", "4x1", "gray 2x2",
    "ids 1,2,3 no Adobe", "CMYK", "JFIF (YCbCr)", "Adobe YCCK",
    "restart not a row"])
def test_lossless_layouts_and_colour(jenc, case):
    """Restart intervals (whole MCU rows, the only ones libjpeg allows
    here), one scan a component, subsampled components (upsampled by
    replication), the colour spaces libjpeg reads without conversion, and
    the ones it refuses to convert in lossless mode."""
    data, refused = _lossless_layout(jenc, case)
    assert_same_as_pillow(data, refused=refused)


# -------------------------------------------------------- block smoothing

SCRIPTS = {
    "dc only": "012:0:0:0:0",
    "dc al1": "012:0:0:0:1",
    "dc, ac 1-2": "012:0:0:0:0;0:1:2:0:0",
    "ac al1": "012:0:0:0:0;0:1:63:0:1;1:1:63:0:1;2:1:63:0:1",
    "refined": "012:0:0:0:2;0:1:5:0:1;0:6:63:0:0;012:0:0:2:1",
    "dc by component": "0:0:0:0:0;1:0:0:0:0;2:0:0:0:0;0:1:9:0:1",
}


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_block_smoothing_bit_equal_to_pillow(jenc, script, coding,
                                             sampling):
    """Progressive scan scripts that leave zigzag coefficients 1-9
    incomplete, which libjpeg's output pass smooths (DC interpolation
    where no AC band was sent), Huffman and arithmetic; sizes with one-
    and two-block-wide planes and a partial last iMCU row among them."""
    for seed, hw in enumerate([(33, 15), (9, 17), (57, 83)]):
        img = image(*hw, seed=seed)
        data = encode(jenc, img, f"arith={int(coding == 'arithmetic')}",
                      "samp=" + SAMPLINGS[sampling],
                      "scans=" + SCRIPTS[script])
        assert_same_as_pillow(data)


@pytest.mark.parametrize("n", range(1, 10))
def test_pillows_progressive_jpeg_cut_after_n_scans(n):
    """Pillow's own progressive JPEG (10 scans) ended after each of its
    first 9: every cut but the last leaves coefficients to smooth."""
    data = first_scans(pillow_jpeg(image(61, 97, seed=n),
                                   progressive=True), n)
    assert_same_as_pillow(data)


# ------------------------------------------- EXIF, corruption, streaming


def _formats(jenc):
    img = image(40, 70, seed=9)
    return {
        "arithmetic": encode(jenc, img, "arith=1", "restart=3"),
        "arithmetic progressive": encode(jenc, img, "arith=1", "prog=1",
                                         "restart=2"),
        "lossless": encode(jenc, img, "lossless=7,1", "rows=2"),
        "arithmetic smoothed": encode(jenc, img, "arith=1",
                                      "scans=" + SCRIPTS["refined"]),
        "huffman smoothed": encode(jenc, img, "scans=" + SCRIPTS["dc only"]),
        "huffman baseline": pillow_jpeg(img),
        "huffman progressive": pillow_jpeg(img, progressive=True),
        "huffman restarts": encode(jenc, img, "restart=2"),
    }


@pytest.mark.parametrize("orientation", [3, 6])
@pytest.mark.parametrize("fmt", ["arithmetic", "arithmetic progressive",
                                 "lossless", "huffman smoothed"])
def test_exif_orientation_on_new_formats(jenc, fmt, orientation):
    data = with_orientation(_formats(jenc)[fmt], orientation)
    assert_same_as_pillow(data)
    if orientation == 6:
        assert decode_upload(data).shape[:2] == (70, 40)


@pytest.mark.parametrize("fmt", [
    "arithmetic", "arithmetic progressive", "lossless", "arithmetic smoothed",
    "huffman baseline", "huffman progressive", "huffman restarts",
    "huffman smoothed"])
def test_truncations_and_byte_flips_as_pillow(jenc, fmt):
    """64 truncations and 200 single-byte changes of each file: the port
    decodes each as Pillow does or both refuse. Flips in the coded data
    give libjpeg's answer to corrupt data: the arithmetic decoder's
    skipped restart interval; a Huffman code of more than 16 bits decoded
    as 0; past a marker, the rest of the restart interval left as it was
    (zero blocks; zero lossless differences from a reset prediction);
    restart resynchronisation; out-of-range coefficients through the SIMD
    IDCT's 16-bit arithmetic. Cuts give libjpeg's bit reader's answer: a
    scan whose reads run past the end before a marker is refused, as
    Pillow refuses it ("image file is truncated"). Flips in the headers
    give the refusals of libjpeg's marker reader."""
    data = _formats(jenc)[fmt]
    rng = np.random.default_rng(len(data))
    bad = []
    for cut in sorted(set(rng.integers(2, len(data), 61).tolist()
                          + [len(data) - 1, len(data) - 2, len(data) - 3])):
        if not agree_with_pillow(data[:cut]):
            bad.append(("cut", cut))
    for _ in range(200):
        pos, value = int(rng.integers(2, len(data))), int(rng.integers(256))
        flipped = bytearray(data)
        flipped[pos] = value
        if not agree_with_pillow(bytes(flipped)):
            bad.append(("flip", pos, value))
    assert not bad


@pytest.mark.parametrize("fmt", ["huffman baseline", "huffman progressive",
                                 "lossless", "arithmetic progressive"])
def test_inserted_markers_and_bytes_as_pillow(jenc, fmt):
    """150 files with a marker (0xFF and a random code) put in at a random
    place, or a byte taken out: in the coded data, a marker ends it early;
    in the headers, it is read as libjpeg reads it."""
    data = _formats(jenc)[fmt]
    rng = np.random.default_rng(len(data) + 1)
    bad = []
    for i in range(150):
        pos = int(rng.integers(2, len(data)))
        if i % 3:
            changed = data[:pos] + bytes([0xFF, int(rng.integers(256))]) \
                + data[pos:]
        else:
            changed = data[:pos] + data[pos + 1:]
        if not agree_with_pillow(changed):
            bad.append((i, pos))
    assert not bad


@pytest.mark.parametrize("name", ["strip.jpg", "scene_exif6.jpg"])
def test_cut_fixture_files_as_pillow(name):
    """The committed baseline JPEGs (100-180 KB, fed to libjpeg by Pillow
    in 64 KiB blocks) cut at their last 40 bytes and at 40 other places:
    decoded as Pillow decodes them, or refused where Pillow refuses."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(0)
    cuts = sorted({len(data) - k for k in range(1, 41)}
                  | set(rng.integers(2, len(data), 40).tolist()))
    assert not [c for c in cuts if not agree_with_pillow(data[:c])]


def _padded(data: bytes, total: int) -> bytes:
    """COM segments after SOI bringing the file to `total` bytes."""
    extra, segs = total - len(data), b""
    while extra:
        n = min(extra, 60000)
        if 0 < extra - n < 4:
            n -= 4
        segs += struct.pack(">BBH", 0xFF, 0xFE, n - 2) + b"x" * (n - 4)
        extra -= n
    return data[:2] + segs + data[2:]


@pytest.mark.parametrize("total", [65535, 65536, 65537])
def test_pillow_streaming_limit_sequential(jenc, total):
    """Pillow hands libjpeg 64 KiB (`ImageFile.MAXBLOCK`) a call, and
    libjpeg's arithmetic decoder cannot wait for more: a sequential scan
    decodes only while every byte it reads, here up to the EOI marker it
    runs into, lies in the first 65,536. Padded to one byte either side
    of that."""
    data = _padded(encode(jenc, image(400, 500, seed=2), "arith=1"), total)
    assert len(data) == total
    assert_same_as_pillow(data, refused=total > 65536)


@pytest.mark.parametrize("header_end", [65535, 65536, 65537, 65538])
def test_pillow_streaming_limit_progressive(jenc, header_end):
    """A progressive file's scan is decoded in the call whose data first
    holds its whole header: a scan header ending at byte 65,536 has its
    data cut at 65,536, one ending past it gets the next 64 KiB. A COM
    segment before the scan that crosses the boundary moves its header
    end around it."""
    data = encode(jenc, image(560, 720, seed=2), "arith=1", "prog=1")
    sos = [s for s in segments(data) if s[0] == 0xDA and s[1] < 65536]
    _, start, end = sos[-1]
    moved = with_segment(data, 0xFE, b"y" * (header_end - end - 4),
                         before=start)
    assert [s for s in segments(moved) if s[0] == 0xDA][len(sos) - 1][2] \
        == header_end
    assert_same_as_pillow(moved, refused=header_end <= 65536)


def _refusal(jenc, case):
    seq = encode(jenc, image(24, 40, seed=5), "arith=1")
    if case.startswith("SOF"):
        marker = {"SOF11": 0xCB, "SOF13": 0xCD, "SOF14": 0xCE,
                  "SOF15": 0xCF}[case]
        return seq.replace(b"\xff\xc9", bytes([0xFF, marker]), 1)
    if case in ("12-bit", "16-bit"):
        b = bytearray(seq)
        b[b.index(b"\xff\xc9") + 4] = int(case[:2])
        return bytes(b)
    b = bytearray(seq)
    dac = b.index(b"\xff\xcc")
    if case == "DAC L > U":
        b[dac + 5] = 0x12  # U 1, L 2
    elif case == "DAC odd length":
        b[dac + 3] += 1
    elif case == "DAC index":
        b[dac + 4] = 0x20
    return bytes(b)


@pytest.mark.parametrize("case", ["SOF11", "SOF13", "SOF14", "SOF15",
                                  "12-bit", "16-bit", "DAC L > U",
                                  "DAC odd length", "DAC index"])
def test_refused_as_pillow_refuses(jenc, case):
    """Lossless arithmetic coding (SOF11: libjpeg-turbo 3.1 has no
    decoder), hierarchical arithmetic frames (SOF13-15), precisions other
    than 8 (Pillow: "cannot handle N-bit layers") and bad DAC segments:
    both refuse, the port with BadRequest."""
    data = _refusal(jenc, case)
    assert pillow(data) is None
    with pytest.raises(BadRequest):
        decode_upload(data)


def _big_tables(data: bytes, scale: int) -> bytes:
    """The file's DQT tables rewritten at 16-bit precision, each value
    times `scale`: the same coefficients dequantise past 16 bits."""
    out = data[:2]
    for marker, start, end in segments(data):
        seg = data[start:end]
        if marker == 0xDB:
            body, tables = seg[4:], b""
            for j in range(0, len(body), 65):
                vals = [min(65535, v * scale) for v in body[j + 1:j + 65]]
                tables += bytes([0x10 | body[j] & 15]) + struct.pack(
                    ">64H", *vals)
            seg = struct.pack(">BBH", 0xFF, 0xDB, len(tables) + 2) + tables
        out += seg
        if marker == 0xDA:
            return out + data[end:]
    raise AssertionError("no scan")


def _odd_file(jenc, case):
    base = pillow_jpeg(image(40, 64, seed=3), quality=90)
    sos = base.index(b"\xff\xda")
    eoi = base.rindex(b"\xff\xd9")
    if case.startswith("16-bit tables"):
        return _big_tables(base, int(case.split("x")[1])), False
    if case == "marker 0x02":
        return with_segment(base, 0x02, b"ab", before=sos), True
    if case == "marker JPG (0xC8)":
        return with_segment(base, 0xC8, b"ab", before=sos), True
    if case == "TEM before the scan":
        return base[:sos] + b"\xff\x01" + base[sos:], True
    if case == "no 0xFF after SOI":
        return base[:2] + b"\x00" + base[2:], True
    if case == "DNL after the scan":
        return base[:eoi] + b"\xff\xdc\x00\x04\x00\x28" + base[eoi:], False
    if case == "second scan, single-scan file":
        return base[:eoi] + base[sos:eoi] + base[eoi:], True
    if case == "component in no scan":
        data = bytearray(encode(jenc, image(40, 64, seed=3), "arith=1",
                                "scans=0:0:0:0:0;1:0:0:0:0;2:0:0:0:0"))
        last = [s for s in segments(bytes(data)) if s[0] == 0xDA][-1][1]
        data[last + 5] = data[data.index(b"\xff\xca") + 10]  # comp 1's id
        return bytes(data), False
    if case == "DRI of length 5":
        return with_segment(base, 0xDD, b"\x00\x04\x00", before=sos), True
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "16-bit tables x40", "16-bit tables x1000", "marker 0x02",
    "marker JPG (0xC8)", "TEM before the scan", "no 0xFF after SOI",
    "DNL after the scan", "second scan, single-scan file",
    "component in no scan", "DRI of length 5"])
def test_libjpegs_answers_on_odd_files(jenc, case):
    """What this decoder shares with the Huffman path, held to libjpeg's
    answers (all but the DRI case were answered otherwise before this
    file came): dequantised
    coefficients past 16 bits through the SIMD IDCT's wrapping and
    saturating lanes; the markers libjpeg's reader refuses (reserved, JPG,
    TEM ahead of the scan where Pillow's own parser refuses it, no 0xFF
    after SOI: Pillow's signature); a DNL segment, skipped; a second scan
    where a single-scan file should end; a component no scan names (zero
    coefficients and an all-zero dequantisation table: grey); a DRI
    segment of the wrong length."""
    data, refused = _odd_file(jenc, case)
    assert_same_as_pillow(data, refused=refused)


def test_mpo_decodes_as_its_first_frame():
    """An MPO (two JPEGs, Pillow's "MPO" format, as 3D and burst cameras
    write them) decodes as Pillow decodes it: its first frame."""
    img = image(40, 64, seed=2)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="MPO", save_all=True,
                              append_images=[Image.fromarray(img[::-1])])
    data = buf.getvalue()
    assert Image.open(io.BytesIO(data)).format == "MPO"
    assert_same_as_pillow(data)


# ---------------------------------------------------------------- fixtures


def make_jpeg_fixtures(jenc) -> dict:
    """The JPEG fixtures of this slice that `chip_smoke.py` decodes on the
    card, built from the committed `strip.jpg` (decoded by the port):
    name -> bytes. Regenerate them, and their entries in
    `pillow_rgb_sha256.json`, with this function if `strip.jpg`
    changes."""
    with open(os.path.join(FIXTURES, "strip.jpg"), "rb") as f:
        strip = decode_upload(f.read())
    return {
        "strip_arith.jpg": encode(jenc, strip[:, :1250], "arith=1"),
        "strip_arith_prog.jpg": encode(jenc, strip[:, 1250:], "arith=1",
                                       "prog=1"),
        "strip_lossless_crop.jpg": encode(jenc, strip[:, 600:800],
                                          "lossless=1,0"),
        "strip_smoothed.jpg": first_scans(pillow_jpeg(strip,
                                                      progressive=True), 2),
        # past the 64 KiB Pillow hands libjpeg at once: refused
        "strip_arith_whole.jpg": encode(jenc, strip, "arith=1"),
    }


def test_committed_jpeg_fixtures(jenc):
    """The committed files are what `make_jpeg_fixtures` builds; Pillow's
    decode of each has the hash in `pillow_rgb_sha256.json`, and the port
    equals it; the whole strip, arithmetic-coded, is the one both refuse."""
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    for name, data in make_jpeg_fixtures(jenc).items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
        if hashes[name].get("refused"):
            assert len(data) > 65536
            assert_same_as_pillow(data, refused=True)
            continue
        assert len(data) < 65536
        assert_same_as_pillow(data)
        rgb = pillow(data)
        assert list(rgb.shape) == hashes[name]["shape"]
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
            hashes[name]["rgb_sha256"]


def test_decode_times_tool(tmp_path):
    """`tools/decode_times.py` on this tree alone: a median decode time
    for every committed JPEG fixture, null for the one the decoder
    refuses."""
    from ecgmm_torch.tools import decode_times

    out = tmp_path / "times.json"
    assert decode_times.main(["--out", str(out)]) == 0
    [row] = json.loads(out.read_text())
    assert row["tree"] == "this"
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert sorted(row["ms"]) == names
    for name, ms in row["ms"].items():
        if hashes[name].get("refused"):
            assert ms is None, name
        else:
            assert ms > 0, name
