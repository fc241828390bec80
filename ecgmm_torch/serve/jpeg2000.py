"""JPEG 2000 uploads (JP2, JPX and raw J2K codestreams) as Pillow 12.1
reads them with openjpeg 2.5.4.

Three layers, each as its original decides:

- Pillow's `Jpeg2KImagePlugin._open` (`_pillow_open`): the signature, the
  size and mode from the SIZ segment or the JP2 header's `ihdr`, `colr`
  (enumerated colour space 12: CMYK) and `pclr` (a palette of up to 8
  bits an entry: modes P and PA, Pillow's own palette of the distinct
  colours), its BoxReader's length rules and the comment reader. Where it
  raises one of the errors `Image.open` steps past, the next plugin is
  tried (`Decline`).
- openjpeg's reading, as Pillow drives it (`opj_read_header`, then
  `opj_read_tile_header` and `opj_decode_tile_data` until no tile is left,
  then `opj_end_decompress`): the JP2 boxes (`_jp2_boxes`), the main
  header's and the tile-part headers' marker segments (SIZ, COD, COC, QCD,
  QCC, RGN, POC, TLM, PLM, PLT, PPM, PPT, CRG, COM, CBD, MCT, MCC, MCO,
  CAP, CPF, SOT), the tile-parts' data and the order tiles are decoded in.
  Strict mode: a tile-part longer than the stream, or a code-block segment
  longer than its packet, refuses the file. Each tile's decoding (tier 2,
  tier 1, the wavelets, the colour transform, the level shift) is C++
  (`native/j2kdec.cpp`).
- Pillow's decoder step (`Jpeg2KDecode.c`): the unpacker its table picks
  by mode, colour space, component count and subsampling, each
  component's precision shifted to 8 bits (16 for I;16) with the offset
  of a signed one, the tile placed into the image, sYCC through Pillow's
  own YCbCr conversion; then `convert("RGB")` (`imdecode._mode_to_rgb`).
  A JPEG 2000 image carries no EXIF orientation for `exif_transpose`.

HTJ2K (Part 15) code-blocks, which openjpeg 2.5.4 also decodes, are
refused by name (ROADMAP.md section 3).

Every allocation is bounded before it is made: the image by
`imdecode._check_pixels` (Pillow's decompression-bomb limit), a tile by
the image, a tile's precincts and code-blocks by `native/j2kdec.cpp`.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ecgmm_torch import native
from ecgmm_torch.serve.imdecode import (STEPPED_PAST, Decline, _bad,
                                        _check_pixels, _mode_to_rgb,
                                        _unsupported)

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
_U32 = 0xFFFFFFFF


def _fail(what: str):
    return _bad(f"JPEG 2000: {what} (openjpeg refuses it)")


# ------------------------------------------------------------ Pillow's _open


class _Reader:
    """A file position over the upload, as Pillow's BytesIO."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = max(len(self.data) - self.pos, 0)
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def seek_cur(self, n: int) -> None:
        if self.pos + n < 0:
            raise ValueError("negative seek value")
        self.pos += n


class _BoxReader:
    """Pillow's BoxReader."""

    def __init__(self, fp: _Reader, length: int = -1):
        self.fp = fp
        self.has_length = length >= 0
        self.length = length
        self.remaining_in_box = -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.pos + n > self.length:
            return False
        if self.remaining_in_box >= 0:
            return n <= self.remaining_in_box
        return True

    def _read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise OSError(f"Expected to read {n} bytes but only got "
                          f"{len(data)}.")
        if self.remaining_in_box > 0:
            self.remaining_in_box -= n
        return data

    def read_fields(self, fmt: str):
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining_in_box
        data = self._read_bytes(size)
        return _BoxReader(_Reader(data), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.pos + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek_cur(self.remaining_in_box)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining_in_box = lbox - hlen
        return tbox


def _parse_codestream(fp: _Reader):
    hdr = fp.read(2)
    lsiz = struct.unpack_from(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        ssiz = struct.unpack_from(">B", siz, 38)
        mode = "I;16" if (ssiz[0] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


class _Palette:
    """What Pillow's ImagePalette.getcolor leaves for the entries of a
    `pclr` box: each distinct colour once, in the order first seen."""

    def __init__(self, mode: str):
        self.mode = mode
        self.colors = {}
        self.palette = bytearray()

    def getcolor(self, color: tuple) -> int:
        if self.mode == "RGB" and len(color) == 4:
            color = color[:3]  # ImagePalette drops an alpha it cannot hold
        elif self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return self.colors[color]
        index = len(self.palette) // 3
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * 3 < len(self.palette):
            self.palette[index * 3:index * 3 + 3] = bytes(color)
        else:
            self.palette += bytes(color)
        return index

    def table(self) -> np.ndarray:
        """The image palette after `putpalette`: the entries the bytes
        hold; an index past them reads black."""
        table = np.zeros((256, 3), np.uint8)
        bits = 32 if self.mode == "RGBA" else 24
        n = min(len(self.palette) * 8 // bits, 256)
        if n:
            entries = np.frombuffer(bytes(self.palette), np.uint8,
                                    n * bits // 8).reshape(n, bits // 8)
            table[:n] = entries[:, :3]
        return table


def _parse_jp2_header(fp: _Reader):
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        elif tbox == b"ftyp":
            reader.read_fields(">4s")
    size = mode = nc = None
    palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            depths = header.read_fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(
                        tuple(header.read_fields(">" + "B" * npc)))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp: _Reader) -> None:
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = struct.unpack_from(">H", fp.read(2))[0]
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek_cur(length - 2)


def _pillow_open(data: bytes):
    """(size, mode, palette) as `Jpeg2KImageFile._open` leaves them."""
    fp = _Reader(data)
    sig = fp.read(4)
    if sig == J2K_SIGNATURE:
        size, mode = _parse_codestream(fp)
        _parse_comment(fp)
        palette = None
    else:
        sig += fp.read(8)
        if sig != JP2_SIGNATURE:
            raise SyntaxError("not a JPEG 2000 file")
        size, mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            length = struct.unpack_from(">H", fp.read(2))[0]
            fp.seek_cur(length - 2)
            _parse_comment(fp)
    return size, mode, palette


# ------------------------------------------------------------ openjpeg


class _Stream:
    """opj_stream over the whole file, as Pillow gives it to openjpeg."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def left(self) -> int:
        return len(self.data) - self.pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def skip(self, n: int) -> bool:
        """opj_stream_skip: True where all n bytes were there."""
        if n <= self.left():
            self.pos += n
            return True
        self.pos = len(self.data)
        return False


# JP2 reading states (opj_jp2.c)
_JP2_SIGNATURE, _JP2_FILE_TYPE, _JP2_HEADER, _JP2_CODESTREAM = 1, 2, 4, 8
_ENUMCS = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}


class _Jp2:
    def __init__(self):
        self.state = 0
        self.has_jp2h = self.has_ihdr = False
        self.numcomps = 0
        self.ihdr_w = self.ihdr_h = 0
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None  # number of palette columns
        self.cmap = False
        self.cdef = False


def _boxhdr(s: _Stream):
    """opj_jp2_read_boxhdr: (length, type, header bytes) or None where the
    stream holds no box header."""
    head = s.read(8)
    if len(head) != 8:
        return None
    length, typ = struct.unpack(">I4s", head)
    if length == 0:
        left = s.left()
        if left > _U32 - 8:
            raise _fail("a box of more than 4 GiB")
        return left + 8, typ, 8
    if length == 1:
        xl = s.read(8)
        if len(xl) != 8:
            return None
        hi, length = struct.unpack(">II", xl)
        if hi:
            raise _fail("a box of more than 4 GiB")
        return length, typ, 16
    return length, typ, 8


def _boxhdr_bytes(body: bytes, at: int):
    """opj_jp2_read_boxhdr_char, for the boxes inside jp2h."""
    size = len(body) - at
    if size < 8:
        raise _fail("a box of less than 8 bytes in jp2h")
    length, typ = struct.unpack_from(">I4s", body, at)
    n = 8
    if length == 1:
        if size < 16:
            raise _fail("an XL box of less than 16 bytes in jp2h")
        hi, length = struct.unpack_from(">II", body, at + 8)
        n = 16
        if hi:
            raise _fail("a box of more than 4 GiB")
        if length == 0:
            raise _fail("a box of undefined size in jp2h")
    elif length == 0:
        raise _fail("a box of undefined size in jp2h")
    if length < n:
        raise _fail("a box length shorter than its header")
    return length, typ, n


def _read_ihdr(jp2: _Jp2, b: bytes) -> None:
    if jp2.has_ihdr:
        return  # openjpeg keeps the first ihdr
    if len(b) != 14:
        raise _fail("a bad ihdr box size")
    h, w, nc = struct.unpack_from(">IIH", b)
    jp2.ihdr_h, jp2.ihdr_w, jp2.numcomps = h, w, nc
    if (nc - 1) & 0xFFFFFFFF >= 16384:
        raise _fail("an invalid number of components in ihdr")
    jp2.has_ihdr = True


def _read_colr(jp2: _Jp2, b: bytes) -> None:
    if len(b) < 3:
        raise _fail("a bad colr box size")
    if jp2.has_colr:
        return
    meth = b[0]
    if meth == 1:
        if len(b) < 7:
            raise _fail("a bad colr box size")
        jp2.enumcs = struct.unpack_from(">I", b, 3)[0]
        jp2.has_colr = True
    elif meth == 2:
        jp2.has_colr = True


def _read_bpcc(jp2: _Jp2, b: bytes) -> None:
    if len(b) != jp2.numcomps:
        raise _fail("a bad bpcc box size")


def _read_pclr(jp2: _Jp2, b: bytes) -> None:
    if jp2.pclr is not None or len(b) < 3:
        raise _fail("a second or short pclr box")
    ne, npc = struct.unpack_from(">HB", b)
    if ne == 0 or ne > 1024:
        raise _fail(f"a pclr box of {ne} entries")
    if npc == 0:
        raise _fail("a pclr box of no columns")
    if len(b) < 3 + npc:
        raise _fail("a short pclr box")
    sizes = [min(((c & 0x7F) + 1 + 7) >> 3, 4) for c in b[3:3 + npc]]
    need = 3 + npc + ne * sum(sizes)
    if len(b) < need:
        raise _fail("a short pclr box")
    jp2.pclr = npc


def _read_cmap(jp2: _Jp2, b: bytes) -> None:
    if jp2.pclr is None:
        raise _fail("a cmap box before the pclr box")
    if jp2.cmap:
        raise _fail("a second cmap box")
    if len(b) < jp2.pclr * 4:
        raise _fail("a short cmap box")
    jp2.cmap = True


def _read_cdef(jp2: _Jp2, b: bytes) -> None:
    if jp2.cdef:
        raise _fail("a second cdef box")
    if len(b) < 2:
        raise _fail("a short cdef box")
    n = struct.unpack_from(">H", b)[0]
    if n == 0:
        raise _fail("a cdef box of no channels")
    if len(b) < 2 + n * 6:
        raise _fail("a short cdef box")
    jp2.cdef = True


_IMG_BOXES = {b"ihdr": _read_ihdr, b"colr": _read_colr, b"bpcc": _read_bpcc,
              b"pclr": _read_pclr, b"cmap": _read_cmap, b"cdef": _read_cdef}


def _read_jp2h(jp2: _Jp2, b: bytes) -> None:
    if not jp2.state & _JP2_FILE_TYPE:
        raise _fail("a jp2h box before the file type box")
    at = 0
    has_ihdr = False
    while at < len(b):
        length, typ, n = _boxhdr_bytes(b, at)
        if length > len(b) - at:
            raise _fail("a box longer than its jp2h box")
        handler = _IMG_BOXES.get(typ)
        if handler is not None:
            handler(jp2, b[at + n:at + length])
        if typ == b"ihdr":
            has_ihdr = True
        at += length
    if not has_ihdr:
        raise _fail("a jp2h box without ihdr")
    jp2.state |= _JP2_HEADER
    jp2.has_jp2h = True


def _read_jp(jp2: _Jp2, b: bytes) -> None:
    if jp2.state != 0:
        raise _fail("a signature box that is not the first")
    if len(b) != 4 or b != b"\x0d\x0a\x87\x0a":
        raise _fail("a bad signature box")
    jp2.state |= _JP2_SIGNATURE


def _read_ftyp(jp2: _Jp2, b: bytes) -> None:
    if jp2.state != _JP2_SIGNATURE:
        raise _fail("a file type box that is not the second")
    if len(b) < 8 or (len(b) - 8) & 3:
        raise _fail("a bad file type box size")
    jp2.state |= _JP2_FILE_TYPE


_TOP_BOXES = {b"jP  ": _read_jp, b"ftyp": _read_ftyp, b"jp2h": _read_jp2h}


def _jp2_boxes(s: _Stream, jp2: _Jp2) -> None:
    """opj_jp2_read_header_procedure: the boxes up to jp2c (or the end)."""
    while True:
        hdr = _boxhdr(s)
        if hdr is None:
            return
        length, typ, nread = hdr
        if typ == b"jp2c":
            if jp2.state & _JP2_HEADER:
                jp2.state |= _JP2_CODESTREAM
                return
            raise _fail("a codestream box before the JP2 header")
        if length == 0:
            raise _fail("a box of undefined size")
        if length < nread:
            raise _fail(f"an invalid box size {length}")
        handler = _TOP_BOXES.get(typ)
        misplaced = _IMG_BOXES.get(typ)
        size = length - nread
        if handler is not None or misplaced is not None:
            if handler is None:
                if not jp2.state & _JP2_HEADER:
                    if not s.skip(size):
                        raise _fail("a box past the end of the file")
                    continue
                handler = misplaced
            if size > s.left():
                raise _fail("a box longer than the file")
            body = s.read(size)
            handler(jp2, body)
        else:
            if not jp2.state & _JP2_SIGNATURE:
                raise _fail("a first box that is not the signature box")
            if not jp2.state & _JP2_FILE_TYPE:
                raise _fail("a second box that is not the file type box")
            if not s.skip(size):
                if jp2.state & _JP2_CODESTREAM:
                    return
                raise _fail("a box past the end of the file")


# markers
SOT, SOD, EOC = 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, QCD, QCC, RGN, POC = (0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D,
                                     0xFF5E, 0xFF5F)
TLM, PLM, PLT, PPM, PPT, CRG, COM = (0xFF55, 0xFF57, 0xFF58, 0xFF60, 0xFF61,
                                     0xFF63, 0xFF64)
SOP, CAP, CPF, MCT, MCC, MCO, CBD = (0xFF91, 0xFF50, 0xFF59, 0xFF74, 0xFF75,
                                     0xFF77, 0xFF78)
# decoder states (j2k.c)
_MHSIZ, _MH, _TPHSOT, _TPH, _NEOC, _DATA, _EOC = 2, 4, 8, 16, 64, 128, 256
_MAXRLVLS, _MAXBANDS, _MAX_POCS = 33, 97, 32
_HT, _HT_MIXED = 0x40, 0x80


class _Tccp:
    __slots__ = ("csty", "numres", "cblkw", "cblkh", "cblksty", "qmfbid",
                 "prcw", "prch", "qntsty", "numgbits", "expn", "mant",
                 "roishift", "dc_shift")

    def __init__(self):
        self.csty = self.numres = self.cblkw = self.cblkh = 0
        self.cblksty = self.qmfbid = self.qntsty = self.numgbits = 0
        self.roishift = self.dc_shift = 0
        self.prcw = [0] * _MAXRLVLS
        self.prch = [0] * _MAXRLVLS
        self.expn = [0] * _MAXBANDS
        self.mant = [0] * _MAXBANDS

    def copy(self) -> "_Tccp":
        t = object.__new__(_Tccp)
        (t.csty, t.numres, t.cblkw, t.cblkh, t.cblksty, t.qmfbid, t.qntsty,
         t.numgbits, t.roishift, t.dc_shift) = (
            self.csty, self.numres, self.cblkw, self.cblkh, self.cblksty,
            self.qmfbid, self.qntsty, self.numgbits, self.roishift,
            self.dc_shift)
        t.prcw, t.prch = self.prcw[:], self.prch[:]
        t.expn, t.mant = self.expn[:], self.mant[:]
        return t


class _Tcp:
    def __init__(self, numcomps: int):
        self.csty = self.prg = self.numlayers = self.mct = 0
        self.tccps = [_Tccp() for _ in range(numcomps)]
        self.poc = False
        self.pocs: List[list] = []
        self.mcc = False
        self.ppt_markers = {}
        self.ppt_buffer: Optional[bytes] = None
        self.data: Optional[bytearray] = None
        self.nb_tile_parts = 0
        self.current_tile_part = -1

    def copy(self) -> "_Tcp":
        t = _Tcp(0)
        t.csty, t.prg, t.numlayers, t.mct = (self.csty, self.prg,
                                             self.numlayers, self.mct)
        t.tccps = [c.copy() for c in self.tccps]
        t.poc = self.poc
        t.pocs = [list(p) for p in self.pocs]
        t.mcc = self.mcc
        return t


class _Comp:
    __slots__ = ("prec", "sgnd", "dx", "dy")


class _Codestream:
    """openjpeg's j2k decoder state over the stream."""

    def __init__(self, s: _Stream, jp2: Optional[_Jp2]):
        self.s = s
        self.jp2 = jp2
        self.state = 0
        self.comps: List[_Comp] = []
        self.default: Optional[_Tcp] = None
        self.tcps = {}  # tile -> _Tcp, copied from `default` on first use
        self.ppm = False
        self.ppm_markers = {}
        self.ppm_data = np.zeros(0, np.uint8)
        self.ppm_at = 0  # the packed headers the tiles decoded have read
        self.current_tile = 0
        self.can_decode = False
        self.last_tile_part = False
        self.sot_length = 0

    # ---------------------------------------------------- helpers

    def _tcp(self) -> _Tcp:
        if self.state == _TPH:
            return self.tile(self.current_tile)
        return self.default

    def tile(self, t: int) -> _Tcp:
        """Tile t's coding parameters: the main header's, copied when the
        tile is first met (openjpeg copies them for every tile at the end
        of the main header, which no later segment changes)."""
        tcp = self.tcps.get(t)
        if tcp is None:
            tcp = self.tcps[t] = self.default.copy()
        return tcp

    def _comp_room(self) -> int:
        return 1 if len(self.comps) <= 256 else 2

    # ---------------------------------------------------- main header

    def read_header(self) -> None:
        s = self.s
        if s.read(2) != b"\xff\x4f":
            raise _fail("no SOC marker")
        self.state = _MHSIZ
        head = s.read(2)
        if len(head) != 2:
            raise _fail("a stream too short")
        marker = struct.unpack(">H", head)[0]
        has = set()
        while marker != SOT:
            if marker < 0xFF00:
                raise _fail(f"{marker:#06x} where a marker was expected")
            states, handler = _HANDLERS.get(marker, _UNKNOWN)
            if (states, handler) == _UNKNOWN:
                marker = self._read_unknown()
                if marker == SOT:
                    break
                states, handler = _HANDLERS.get(marker, _UNKNOWN)
            has.add(marker)
            if not self.state & states:
                raise _fail(f"marker {marker:#06x} out of place")
            size = self._read_u16()
            if size < 2:
                raise _fail("an invalid marker size")
            body = s.read(size - 2)
            if len(body) != size - 2:
                raise _fail("a stream too short")
            handler(self, body)
            marker = self._read_u16()
        for need, name in ((SIZ, "SIZ"), (COD, "COD"), (QCD, "QCD")):
            if need not in has:
                raise _fail(f"no {name} marker in the main header")
        self._merge_ppm()
        self.state = _TPHSOT

    def _read_u16(self) -> int:
        head = self.s.read(2)
        if len(head) != 2:
            raise _fail("a stream too short")
        return struct.unpack(">H", head)[0]

    def _read_unknown(self) -> int:
        """opj_j2k_read_unk: scan two bytes at a time for a known marker."""
        while True:
            m = self._read_u16()
            if m >= 0xFF00:
                states, handler = _HANDLERS.get(m, _UNKNOWN)
                if not self.state & states:
                    raise _fail(f"marker {m:#06x} out of place")
                if (states, handler) != _UNKNOWN:
                    return m

    def _merge_ppm(self) -> None:
        if not self.ppm:
            return
        out = bytearray()
        remaining = 0
        for z in sorted(self.ppm_markers):
            data = self.ppm_markers[z]
            at = 0
            if remaining >= len(data):
                remaining -= len(data)
                out += data
                continue
            out += data[:remaining]
            at = remaining
            remaining = 0
            while at < len(data):
                if len(data) - at < 4:
                    raise _fail("a PPM marker too short for its Nppm")
                n = struct.unpack_from(">I", data, at)[0]
                at += 4
                if len(out) + n > _U32:
                    raise _fail("a PPM Nppm too large")
                take = min(n, len(data) - at)
                out += data[at:at + take]
                at += take
                remaining = n - take
        if remaining:
            raise _fail("corrupted PPM markers")
        self.ppm_data = np.frombuffer(bytes(out), np.uint8)

    # ---------------------------------------------------- tiles

    def read_tile_header(self) -> Optional[int]:
        """opj_j2k_read_tile_header: the next tile to decode, or None."""
        s = self.s
        marker = SOT
        if self.state == _EOC:
            marker = EOC
        elif self.state != _TPHSOT:
            raise _fail("a tile header where none can start")
        nb_tiles = self.tw * self.th
        while not self.can_decode and marker != EOC:
            while marker != SOD:
                if s.left() == 0:
                    self.state = _NEOC
                    break
                size = self._read_u16()
                if size < 2:
                    raise _fail("an inconsistent marker size")
                if marker == 0x8080 and s.left() == 0:
                    self.state = _NEOC
                    break
                if self.state & _TPH and self.sot_length:
                    if self.sot_length < size + 2:
                        raise _fail("a tile-part shorter than its markers")
                    self.sot_length -= size + 2
                states, handler = _HANDLERS.get(marker, _UNKNOWN)
                if not self.state & states:
                    raise _fail(f"marker {marker:#06x} out of place")
                body = s.read(size - 2)
                if len(body) != size - 2:
                    raise _fail("a stream too short")
                if handler is None:
                    raise _fail(f"an unknown marker {marker:#06x} in a "
                                "tile-part header")
                handler(self, body)
                marker = self._read_u16()
            if s.left() == 0 and self.state == _NEOC:
                break
            self._read_sod()
            if not self.can_decode:
                head = s.read(2)
                if len(head) != 2:
                    if self.current_tile + 1 == nb_tiles:
                        found = None
                        for t in sorted(self.tcps):
                            tcp = self.tcps[t]
                            if tcp.current_tile_part == 0 and \
                                    tcp.nb_tile_parts == 0:
                                found = t
                                break
                        if found is not None:
                            self.current_tile = found
                            marker = EOC
                            self.state = _EOC
                            break
                    raise _fail("a stream too short")
                marker = struct.unpack(">H", head)[0]
        if marker == EOC and self.state != _EOC:
            self.current_tile = 0
            self.state = _EOC
        if not self.can_decode:
            # step the cursor on to the next tile holding data, as openjpeg
            # does: once at EOC it only moves forward, so the whole decode
            # scans the tiles once
            t = self.current_tile
            while t < nb_tiles and (self.tcps.get(t) is None or
                                    self.tcps[t].data is None):
                t += 1
            self.current_tile = t
            if t == nb_tiles:
                return None
        tcp = self.tile(self.current_tile)
        if tcp.ppt_buffer is not None:
            raise _fail("PPT data merged twice")
        if tcp.ppt_markers:
            tcp.ppt_buffer = b"".join(tcp.ppt_markers[z]
                                      for z in sorted(tcp.ppt_markers))
        self.state |= _DATA
        return self.current_tile

    def _read_sod(self) -> None:
        s = self.s
        tcp = self.tile(self.current_tile)
        if self.last_tile_part:
            self.sot_length = (s.left() - 2) & _U32
        elif self.sot_length >= 2:
            self.sot_length -= 2
        if self.sot_length:
            if self.sot_length > s.left():
                raise _fail("a tile-part longer than the stream")
            if self.sot_length > _U32 - 2:
                raise _fail("a tile-part too long")
            if tcp.data is None:
                tcp.data = bytearray()
            tcp.data += s.read(self.sot_length)
        self.state = _TPHSOT

    def finish_tile(self) -> None:
        """The end of opj_j2k_decode_tile: the next marker."""
        s = self.s
        tcp = self.tile(self.current_tile)
        tcp.data = None
        self.can_decode = False
        self.state &= ~_DATA
        if s.left() == 0 and self.state == _NEOC:
            return
        if self.state != _EOC:
            head = s.read(2)
            if len(head) != 2:
                raise _fail("a stream too short after a tile")
            marker = struct.unpack(">H", head)[0]
            if marker == EOC:
                self.current_tile = 0
                self.state = _EOC
            elif marker != SOT:
                if s.left() == 0:
                    self.state = _NEOC
                    return
                raise _fail("no SOT marker after a tile")

    def tile_params(self, t: int):
        """The tile's box on the reference grid and its parameters for
        `ecgmm_j2k_tile`."""
        tcp = self.tile(t)
        p, q = t % self.tw, t // self.tw
        tx0 = self.tx0 + p * self.tdx
        x0 = max(tx0, self.x0)
        x1 = min(min(tx0 + self.tdx, _U32), self.x1)
        ty0 = self.ty0 + q * self.tdy
        y0 = max(ty0, self.y0)
        y1 = min(min(ty0 + self.tdy, _U32), self.y1)
        if x0 >= 1 << 31 or x1 >= 1 << 31 or x1 <= x0:
            raise _fail("tile X coordinates it does not support")
        if y0 >= 1 << 31 or y1 >= 1 << 31 or y1 <= y0:
            raise _fail("tile Y coordinates it does not support")
        for tccp in tcp.tccps:
            if tccp.cblksty & _HT:
                raise _unsupported("a JPEG 2000 file of HTJ2K (Part 15) "
                                   "code-blocks")
        params = [x0, y0, x1, y1, len(self.comps), tcp.prg, tcp.numlayers,
                  tcp.mct, tcp.csty, int(tcp.poc),
                  len(tcp.pocs) if tcp.poc else 0]
        if tcp.poc:
            for poc in tcp.pocs:
                params += poc
        for comp, tccp in zip(self.comps, tcp.tccps):
            params += [comp.dx, comp.dy, comp.prec, comp.sgnd, tccp.numres,
                       tccp.cblkw, tccp.cblkh, tccp.cblksty, tccp.qmfbid,
                       tccp.qntsty, tccp.numgbits, tccp.roishift,
                       tccp.dc_shift]
            params += tccp.prcw + tccp.prch + tccp.expn + tccp.mant
        return (x0, y0, x1, y1), np.array(params, np.int64)


# ---------------------------------------------------------------- segments


def _read_siz(cs: _Codestream, b: bytes) -> None:
    if len(b) < 36 or (len(b) - 36) % 3:
        raise _fail("a bad SIZ marker size")
    (_, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
     nc) = struct.unpack_from(">HIIIIIIIIH", b)
    if nc >= 16385:
        raise _fail(f"{nc} components")
    if nc != (len(b) - 36) // 3:
        raise _fail("a SIZ component count its size does not hold")
    if x0 >= x1 or y0 >= y1:
        raise _fail("a negative or empty image")
    if tdx == 0 or tdy == 0:
        raise _fail("an empty tile size")
    if tx0 > x0 or ty0 > y0 or min(tx0 + tdx, _U32) <= x0 or \
            min(ty0 + tdy, _U32) <= y0:
        raise _fail("an illegal tile offset")
    jp2 = cs.jp2
    if jp2 is not None and jp2.ihdr_w > 0 and jp2.ihdr_h > 0 and \
            (jp2.ihdr_w != x1 - x0 or jp2.ihdr_h != y1 - y0):
        raise _fail("an image size unlike the ihdr box's")
    comps = []
    for i in range(nc):
        t, dx, dy = b[36 + 3 * i:39 + 3 * i]
        c = _Comp()
        c.prec, c.sgnd, c.dx, c.dy = (t & 0x7F) + 1, t >> 7, dx, dy
        if not (1 <= dx <= 255 and 1 <= dy <= 255):
            raise _fail(f"component subsampling {dx}x{dy}")
        if c.prec > 31:
            raise _fail(f"a precision of {c.prec} bits")
        comps.append(c)
    tw = -(-(x1 - tx0) // tdx)
    th = -(-(y1 - ty0) // tdy)
    if tw == 0 or th == 0 or tw > 65535 // th:
        raise _fail(f"{tw} x {th} tiles")
    cs.x0, cs.y0, cs.x1, cs.y1 = x0, y0, x1, y1
    cs.tdx, cs.tdy, cs.tx0, cs.ty0 = tdx, tdy, tx0, ty0
    cs.tw, cs.th = tw, th
    cs.comps = comps
    cs.default = _Tcp(nc)
    for comp, tccp in zip(comps, cs.default.tccps):
        # openjpeg sets the level shift here, from SIZ: a CBD segment
        # changes the precision but not the shift
        tccp.dc_shift = 0 if comp.sgnd else 1 << (comp.prec - 1)
    cs.state = _MH


def _spcod(cs: _Codestream, tccp: _Tccp, b: bytes, at: int) -> int:
    """opj_j2k_read_SPCod_SPCoc: returns the bytes left after it."""
    size = len(b) - at
    if size < 5:
        raise _fail("a short SPcod/SPcoc")
    numres = b[at] + 1
    if numres > _MAXRLVLS:
        raise _fail(f"{numres} resolutions")
    cblkw, cblkh = b[at + 1] + 2, b[at + 2] + 2
    if cblkw > 10 or cblkh > 10 or cblkw + cblkh > 12:
        raise _fail("an invalid code-block size")
    cblksty, qmfbid = b[at + 3], b[at + 4]
    if cblksty & _HT_MIXED:
        raise _fail("mixed HT code-blocks")
    if qmfbid > 1:
        raise _fail("an invalid wavelet")
    tccp.numres, tccp.cblkw, tccp.cblkh = numres, cblkw, cblkh
    tccp.cblksty, tccp.qmfbid = cblksty, qmfbid
    size -= 5
    at += 5
    if tccp.csty & 1:
        if size < numres:
            raise _fail("a short precinct size list")
        for i in range(numres):
            v = b[at + i]
            if i != 0 and ((v & 0xF) == 0 or (v >> 4) == 0):
                raise _fail("an invalid precinct size")
            tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
        size -= numres
    else:
        for i in range(numres):
            tccp.prcw[i] = tccp.prch[i] = 15
    return size


def _read_cod(cs: _Codestream, b: bytes) -> None:
    tcp = cs._tcp()
    if len(b) < 5:
        raise _fail("a short COD marker")
    if not cs.comps:
        raise _fail("a COD marker for an image of no components")
    csty, prg, numlayers, mct = struct.unpack_from(">BBHB", b)
    if csty & ~0x07:
        raise _fail("an unknown Scod")
    tcp.csty = csty
    tcp.prg = prg if prg <= 4 else -1
    if numlayers < 1:
        raise _fail("no layers")
    tcp.numlayers = numlayers
    if mct > 1:
        raise _fail("an invalid multiple component transform")
    tcp.mct = mct
    for tccp in tcp.tccps:
        tccp.csty = csty & 1
    if _spcod(cs, tcp.tccps[0], b, 5):
        raise _fail("a COD marker longer than its fields")
    ref = tcp.tccps[0]
    for tccp in tcp.tccps[1:]:
        tccp.numres, tccp.cblkw, tccp.cblkh = ref.numres, ref.cblkw, ref.cblkh
        tccp.cblksty, tccp.qmfbid = ref.cblksty, ref.qmfbid
        tccp.prcw[:ref.numres] = ref.prcw[:ref.numres]
        tccp.prch[:ref.numres] = ref.prch[:ref.numres]


def _read_coc(cs: _Codestream, b: bytes) -> None:
    tcp = cs._tcp()
    room = cs._comp_room()
    if len(b) < room + 1:
        raise _fail("a short COC marker")
    compno = b[0] if room == 1 else struct.unpack_from(">H", b)[0]
    if compno >= len(cs.comps):
        raise _fail("a COC marker for a component the image lacks")
    tcp.tccps[compno].csty = b[room]
    if _spcod(cs, tcp.tccps[compno], b, room + 1):
        raise _fail("a COC marker longer than its fields")


def _sqcd(cs: _Codestream, compno: int, b: bytes, at: int) -> int:
    tcp = cs._tcp()
    if compno >= len(cs.comps):
        raise _fail("a quantisation marker for a component the image lacks")
    tccp = tcp.tccps[compno]
    size = len(b) - at
    if size < 1:
        raise _fail("a short SQcd/SQcc")
    size -= 1
    v = b[at]
    at += 1
    tccp.qntsty, tccp.numgbits = v & 0x1F, v >> 5
    if tccp.qntsty == 1:
        nbands = 1
    else:
        nbands = size if tccp.qntsty == 0 else size // 2
    if tccp.qntsty == 0:
        for i in range(nbands):
            if i < _MAXBANDS:
                tccp.expn[i], tccp.mant[i] = b[at + i] >> 3, 0
        if size < nbands:
            raise _fail("a short quantisation marker")
        size -= nbands
    else:
        if size < 2 * nbands:
            raise _fail("a short quantisation marker")
        for i in range(nbands):
            t = struct.unpack_from(">H", b, at + 2 * i)[0]
            if i < _MAXBANDS:
                tccp.expn[i], tccp.mant[i] = t >> 11, t & 0x7FF
        size -= 2 * nbands
    if tccp.qntsty == 1:
        for i in range(1, _MAXBANDS):
            tccp.expn[i] = max(tccp.expn[0] - (i - 1) // 3, 0)
            tccp.mant[i] = tccp.mant[0]
    return size


def _read_qcd(cs: _Codestream, b: bytes) -> None:
    if _sqcd(cs, 0, b, 0):
        raise _fail("a QCD marker longer than its fields")
    tcp = cs._tcp()
    ref = tcp.tccps[0]
    for tccp in tcp.tccps[1:]:
        tccp.qntsty, tccp.numgbits = ref.qntsty, ref.numgbits
        tccp.expn, tccp.mant = list(ref.expn), list(ref.mant)


def _read_qcc(cs: _Codestream, b: bytes) -> None:
    room = cs._comp_room()
    if len(b) < room:
        raise _fail("a short QCC marker")
    compno = b[0] if room == 1 else struct.unpack_from(">H", b)[0]
    if compno >= len(cs.comps):
        raise _fail("a QCC marker for a component the image lacks")
    if _sqcd(cs, compno, b, room):
        raise _fail("a QCC marker longer than its fields")


def _read_rgn(cs: _Codestream, b: bytes) -> None:
    room = cs._comp_room()
    if len(b) != 2 + room:
        raise _fail("a bad RGN marker size")
    compno = b[0] if room == 1 else struct.unpack_from(">H", b)[0]
    if compno >= len(cs.comps):
        raise _fail("an RGN marker for a component the image lacks")
    cs._tcp().tccps[compno].roishift = b[room + 1]


def _read_poc(cs: _Codestream, b: bytes) -> None:
    room = cs._comp_room()
    chunk = 5 + 2 * room
    n, rest = divmod(len(b), chunk)
    if n <= 0 or rest:
        raise _fail("a bad POC marker size")
    tcp = cs._tcp()
    old = len(tcp.pocs) if tcp.poc else 0
    if old + n >= _MAX_POCS:
        raise _fail(f"{old + n} progression order changes")
    tcp.poc = True
    del tcp.pocs[old:]
    nc = len(cs.comps)
    fmt = ">BBHBBB" if room == 1 else ">BHHBHB"
    for i in range(n):
        r0, c0, l1, r1, c1, prg = struct.unpack_from(fmt, b, i * chunk)
        tcp.pocs.append([r0, c0, min(l1, tcp.numlayers), r1, min(c1, nc),
                         prg])


def _read_tlm(cs: _Codestream, b: bytes) -> None:
    if len(b) < 2:
        raise _fail("a short TLM marker")


def _read_plm(cs: _Codestream, b: bytes) -> None:
    if len(b) < 1:
        raise _fail("a short PLM marker")


def _read_plt(cs: _Codestream, b: bytes) -> None:
    if len(b) < 1:
        raise _fail("a short PLT marker")
    length = 0
    for v in b[1:]:
        length = (length | (v & 0x7F)) & _U32
        length = (length << 7) & _U32 if v & 0x80 else 0
    if length:
        raise _fail("a PLT marker that ends inside a length")


def _read_ppm(cs: _Codestream, b: bytes) -> None:
    if len(b) < 2:
        raise _fail("a short PPM marker")
    cs.ppm = True
    z = b[0]
    if z in cs.ppm_markers:
        raise _fail(f"PPM marker {z} twice")
    cs.ppm_markers[z] = b[1:]


def _read_ppt(cs: _Codestream, b: bytes) -> None:
    if len(b) < 2:
        raise _fail("a short PPT marker")
    if cs.ppm:
        raise _fail("PPT markers beside a PPM marker")
    tcp = cs.tile(cs.current_tile)
    z = b[0]
    if z in tcp.ppt_markers:
        raise _fail(f"PPT marker {z} twice")
    tcp.ppt_markers[z] = b[1:]


def _read_crg(cs: _Codestream, b: bytes) -> None:
    if len(b) != len(cs.comps) * 4:
        raise _fail("a bad CRG marker size")


def _read_com(cs: _Codestream, b: bytes) -> None:
    pass


def _read_cbd(cs: _Codestream, b: bytes) -> None:
    nc = len(cs.comps)
    if len(b) != nc + 2:
        raise _fail("a bad CBD marker size")
    if struct.unpack_from(">H", b)[0] != nc:
        raise _fail("a CBD marker of another component count")
    for comp, v in zip(cs.comps, b[2:]):
        comp.sgnd, comp.prec = (v >> 7) & 1, (v & 0x7F) + 1
        if comp.prec > 31:
            raise _fail(f"a precision of {comp.prec} bits")


def _read_mct(cs: _Codestream, b: bytes) -> None:
    """MCT (Part 2): its size checks; the array it holds is used only by
    the custom transform COD cannot select."""
    if len(b) < 2:
        raise _fail("a short MCT marker")
    if struct.unpack_from(">H", b)[0] != 0:
        return
    if len(b) <= 6:
        raise _fail("a short MCT marker")


def _read_mcc(cs: _Codestream, b: bytes) -> None:
    """MCC (Part 2): its checks where it is first read; a collection that
    an MCO segment applies is refused there."""
    if len(b) < 2:
        raise _fail("a short MCC marker")
    if struct.unpack_from(">H", b)[0] != 0:
        return
    if len(b) < 7:
        raise _fail("a short MCC marker")
    cs._tcp().mcc = True


def _read_mco(cs: _Codestream, b: bytes) -> None:
    """MCO (Part 2): openjpeg zeroes every component's level shift, then
    applies each stage's MCC collection (none without an MCC segment)."""
    if len(b) < 1:
        raise _fail("a short MCO marker")
    if b[0] > 1:
        return
    if len(b) != b[0] + 1:
        raise _fail("a bad MCO marker size")
    tcp = cs._tcp()
    for tccp in tcp.tccps:
        tccp.dc_shift = 0
    if b[0] and tcp.mcc:
        raise _unsupported("a JPEG 2000 file of Part 2 component "
                           "transformations")


def _read_cap(cs: _Codestream, b: bytes) -> None:
    pass


def _read_cpf(cs: _Codestream, b: bytes) -> None:
    pass


def _read_sot(cs: _Codestream, b: bytes) -> None:
    if len(b) != 8:
        raise _fail("a bad SOT marker size")
    tile, psot, part, parts = struct.unpack(">HIBB", b)
    if tile >= cs.tw * cs.th:
        raise _fail(f"tile number {tile}")
    cs.current_tile = tile
    tcp = cs.tile(tile)
    if tcp.current_tile_part + 1 != part:
        raise _fail(f"tile-part {part} of tile {tile} out of order")
    tcp.current_tile_part = part
    if psot != 0 and psot < 14 and psot != 12:
        raise _fail(f"a tile-part length of {psot}")
    if not psot:
        cs.last_tile_part = True
    if tcp.nb_tile_parts and part >= tcp.nb_tile_parts:
        raise _fail("a tile-part index past the tile's count")
    if parts:
        if part >= parts:
            raise _fail("a tile-part index past its own count")
        tcp.nb_tile_parts = parts
    if tcp.nb_tile_parts and tcp.nb_tile_parts == part + 1:
        cs.can_decode = True
    cs.sot_length = 0 if cs.last_tile_part else (psot - 12) & _U32
    cs.state = _TPH


_UNKNOWN = (_MH | _TPH, None)
_HANDLERS = {
    SOT: (_MH | _TPHSOT, _read_sot), COD: (_MH | _TPH, _read_cod),
    COC: (_MH | _TPH, _read_coc), RGN: (_MH | _TPH, _read_rgn),
    QCD: (_MH | _TPH, _read_qcd), QCC: (_MH | _TPH, _read_qcc),
    POC: (_MH | _TPH, _read_poc), SIZ: (_MHSIZ, _read_siz),
    TLM: (_MH, _read_tlm), PLM: (_MH, _read_plm), PLT: (_TPH, _read_plt),
    PPM: (_MH, _read_ppm), PPT: (_TPH, _read_ppt), SOP: (0, None),
    CRG: (_MH, _read_crg), COM: (_MH | _TPH, _read_com),
    MCT: (_MH | _TPH, _read_mct), CBD: (_MH, _read_cbd),
    CAP: (_MH, _read_cap), CPF: (_MH, _read_cpf),
    MCC: (_MH | _TPH, _read_mcc), MCO: (_MH | _TPH, _read_mco),
}


# ------------------------------------------------------------ tile decoding

_TILE_ERRORS = {
    -2: "a code-block segment longer than its packet",
    -3: "a code-block length of more than 32 bits",
    -4: "a code-block of 31 or more bit-planes",
    -5: "components of different sizes under the colour transform",
    -6: "a packet iterator too large",
    -7: "an unknown progression order",
    -8: "precinct geometry beyond 31 bits",
    -9: "more precincts and code-blocks than the port holds",
    -10: "a precinct index past its band",
    -11: "a packet header without its EPH marker",
}


def _decode_tile(lib, cs: _Codestream, t: int, params, buf: np.ndarray):
    """One tile through `ecgmm_j2k_tile`, into `buf` as openjpeg's
    `opj_decode_tile_data` fills Pillow's tile buffer."""
    tcp = cs.tile(t)
    used = np.zeros(1, np.int64)
    if cs.ppm:
        hdr = cs.ppm_data.ctypes.data + cs.ppm_at
        hdr_len = len(cs.ppm_data) - cs.ppm_at
    elif tcp.ppt_buffer is not None:
        hdr, hdr_len = tcp.ppt_buffer, len(tcp.ppt_buffer)
    else:
        hdr, hdr_len = None, -1
    status = lib.ecgmm_j2k_tile(bytes(tcp.data), len(tcp.data), hdr,
                                hdr_len, used.ctypes.data, params.ctypes.data,
                                len(params), buf.ctypes.data, buf.size)
    if cs.ppm:
        cs.ppm_at += int(used[0])
    if status:
        raise _fail(_TILE_ERRORS.get(status, f"tile decoder error {status}"))


# ------------------------------------------------------------ Pillow's step

# Jpeg2KDecode.c's unpackers: (mode, colour space, components) -> (name,
# whether subsampled components are allowed)
_UNPACKERS = {
    ("L", "gray", 1): ("gray_l", False), ("P", "srgb", 1): ("gray_l", False),
    ("PA", "srgb", 2): ("graya_la", False),
    ("I;16", "gray", 1): ("gray_i", False),
    ("LA", "gray", 2): ("graya_la", False),
    ("RGB", "gray", 1): ("gray_rgb", False),
    ("RGB", "gray", 2): ("gray_rgb", False),
    ("RGB", "srgb", 3): ("srgb_rgb", True),
    ("RGB", "sycc", 3): ("sycc_rgb", True),
    ("RGB", "srgb", 4): ("srgb_rgb", True),
    ("RGB", "sycc", 4): ("sycc_rgb", True),
    ("RGBA", "gray", 1): ("gray_rgb", False),
    ("RGBA", "gray", 2): ("graya_la", False),
    ("RGBA", "gray", 4): ("srgba_rgba", True),
    ("RGBA", "srgb", 3): ("srgb_rgb", True),
    ("RGBA", "sycc", 3): ("sycc_rgb", True),
    ("RGBA", "srgb", 4): ("srgba_rgba", True),
    ("RGBA", "sycc", 4): ("sycca_rgba", True),
    ("CMYK", "cmyk", 4): ("srgba_rgba", True),
}
_BANDS = {"L": 1, "P": 1, "I;16": 1, "LA": 4, "PA": 4, "RGB": 4, "RGBA": 4,
          "CMYK": 4}


def _csiz(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _samples(buf: np.ndarray, c: _Comp, base: int, cw: int, dx: int,
             dy: int, ys: np.ndarray, w: int, bits: int) -> np.ndarray:
    """Pillow's reading of one component for image rows `ys` of a tile w
    wide: the word of `_csiz` bytes at base + size * ((y // dy) * cw +
    x // dx), then j2ku_shift(offset + word, shift) to `bits` bits
    (unsigned 32-bit arithmetic, as in C)."""
    n = _csiz(c.prec)
    if dx == 1 and dy == 1 and cw == w:  # whole rows one after another
        at = base + n * w * int(ys[0])
        word = buf[at:at + n * w * len(ys)].view(
            {1: "u1", 2: "<u2", 4: "<u4"}[n]).reshape(len(ys), w).astype(
                np.uint32)
    else:
        off = base + n * ((ys // dy)[:, None] * cw +
                          (np.arange(w) // dx)[None, :])
        word = np.zeros(off.shape, np.uint32)
        for k in range(n):
            word |= buf[off + k].astype(np.uint32) << np.uint32(8 * k)
    shift = bits - c.prec
    offset = (1 << (c.prec - 1)) if c.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = word + np.uint32(offset)
    return x >> np.uint32(-shift) if shift < 0 else x << np.uint32(shift)


_ROWS = 256  # image rows unpacked at once


def _unpack(name: str, cs: _Codestream, buf: np.ndarray, box,
            image) -> None:
    """Pillow's unpacker `name` from the tile buffer into `image`."""
    x0t, y0t, x1t, y1t = box
    x0, y0 = x0t - cs.x0, y0t - cs.y0
    w, h = x1t - x0t, y1t - y0t
    comps = cs.comps
    # (image band(s), component, byte offset, row width, dx, dy)
    if name in ("gray_l", "gray_i", "gray_rgb"):
        bands = [((0, 1, 2) if name == "gray_rgb" else None, comps[0], 0, w,
                  1, 1)]
    elif name == "graya_la":
        bands = [((0, 1, 2), comps[0], 0, w, 1, 1),
                 (3, comps[1], _csiz(comps[0].prec) * w * h, w, 1, 1)]
    else:  # srgb_rgb, sycc_rgb, srgba_rgba, sycca_rgba
        bands, cptr = [], 0
        for k in range(4 if name in ("srgba_rgba", "sycca_rgba") else 3):
            c = comps[k]
            cw = w // c.dx
            bands.append((k, c, cptr, cw, c.dx, c.dy))
            cptr += _csiz(c.prec) * cw * (h // c.dy)
    bits = 16 if name == "gray_i" else 8
    for r0 in range(0, h, _ROWS):
        ys = np.arange(r0, min(r0 + _ROWS, h))
        rows = slice(y0 + r0, y0 + r0 + len(ys))
        if image.ndim == 3:
            out = np.zeros((len(ys), w, 4), np.uint8)
            out[..., 3] = 255
        for band, c, base, cw, dx, dy in bands:
            v = _samples(buf, c, base, cw, dx, dy, ys, w, bits)
            if band is None:
                image[rows, x0:x0 + w] = v.astype(image.dtype)
            else:
                out[..., band] = v.astype(np.uint8)[..., None] \
                    if isinstance(band, tuple) else v.astype(np.uint8)
        if image.ndim == 3:
            if name.startswith("sycc"):
                out = _ycbcr_to_rgb(out)
            if name == "gray_rgb":
                # j2ku_gray_rgb starts the tile x0 bytes into the row of
                # 4-byte pixels, not x0 pixels
                flat = image.reshape(image.shape[0], -1)
                flat[rows, x0:x0 + 4 * w] = out.reshape(len(ys), -1)
            else:
                image[rows, x0:x0 + w] = out


# Pillow's ConvertYCbCr.c tables (SCALE 6): each coefficient times 64
# times (i - 128), rounded as C's (int)(v + 0.5)
_I = np.arange(256) - 128
_R_CR = np.trunc(1.40200 * 64 * _I + 0.5).astype(np.int32)
_G_CB = np.trunc(-0.34414 * 64 * _I + 0.5).astype(np.int32)
_G_CR = np.trunc(-0.71414 * 64 * _I + 0.5).astype(np.int32)
_B_CB = np.trunc(1.77200 * 64 * _I + 0.5).astype(np.int32)


def _ycbcr_to_rgb(p: np.ndarray) -> np.ndarray:
    y = p[..., 0].astype(np.int32)
    cb, cr = p[..., 1], p[..., 2]
    out = p.copy()
    out[..., 0] = np.clip(y + (_R_CR[cr] >> 6), 0, 255)
    out[..., 1] = np.clip(y + ((_G_CB[cb] + _G_CR[cr]) >> 6), 0, 255)
    out[..., 2] = np.clip(y + (_B_CB[cb] >> 6), 0, 255)
    return out


def decode_jpeg2000(data: bytes):
    """The upload as Pillow's `Image.open(f).convert("RGB")` gives it, the
    plugin table's `open` (`rasters.PLUGINS`): (RGB, None, None)."""
    try:
        (width, height), mode, palette = _pillow_open(data)
    except STEPPED_PAST as e:
        raise Decline(f"JPEG 2000: {e}") from None
    except (OSError, ValueError) as e:
        raise _bad(f"JPEG 2000 header: {e}") from None
    if width <= 0 or height <= 0:
        raise Decline("JPEG 2000: no pixels")
    _check_pixels(width, height)
    s = _Stream(data)
    jp2 = None
    if data[:4] != J2K_SIGNATURE:
        jp2 = _Jp2()
        _jp2_boxes(s, jp2)
        if not jp2.has_jp2h:
            raise _fail("no jp2h box")
        if not jp2.has_ihdr:
            raise _fail("no ihdr box")
    cs = _Codestream(s, jp2)
    cs.read_header()
    nc = len(cs.comps)
    space = _ENUMCS.get(jp2.enumcs, "unknown") if jp2 is not None else \
        "unspecified"
    if not 1 <= nc <= 4:
        raise _bad(f"JPEG 2000: {nc} components (Pillow: broken data "
                   "stream)")
    first = next((i for i, c in enumerate(cs.comps)
                  if c.dx != 1 or c.dy != 1), -1)
    subsampled = first != -1
    if space in ("unspecified", "unknown"):
        # Pillow's guess: grey, or sRGB unless the second or third
        # component is the first subsampled one (then sYCC)
        space = "gray" if nc <= 2 else "sycc" if first in (1, 2) else \
            "srgb"
    unpacker = _UNPACKERS.get((mode, space, nc))
    if unpacker is None or (subsampled and not unpacker[1]):
        raise _bad(f"JPEG 2000: no unpacker for mode {mode} from {nc} "
                   f"{space} components (Pillow: broken data stream)")
    name = unpacker[0]
    image = np.zeros((height, width) if _BANDS[mode] == 1 else
                     (height, width, 4),
                     np.uint16 if mode == "I;16" else np.uint8)
    lib = native.library()
    buf = np.zeros(0, np.uint8)
    width_sum = sum((c.prec + 7) >> 3 for c in cs.comps)
    while True:
        t = cs.read_tile_header()
        if t is None:
            break
        box, params = cs.tile_params(t)
        x0, y0, x1, y1 = box
        if x0 < cs.x0 or y0 < cs.y0 or x1 - cs.x0 > width or \
                y1 - cs.y0 > height:
            raise _bad("JPEG 2000: a tile outside the image (Pillow: broken "
                       "data stream)")
        opj_size = 0
        for c in cs.comps:
            cw = -(-x1 // c.dx) - -(-x0 // c.dx)
            ch = -(-y1 // c.dy) - -(-y0 // c.dy)
            opj_size += _csiz(c.prec) * cw * ch
        size = max(opj_size, (x1 - x0) * (y1 - y0) * width_sum)
        if buf.size < size:
            buf = np.zeros(size, np.uint8)
        buf[:size] = 0
        if cs.tile(t).data is None:
            raise _fail("a tile without data")
        _decode_tile(lib, cs, t, params, buf)
        _unpack(name, cs, buf, box, image)
        cs.finish_tile()
    if jp2 is not None:
        _jp2_boxes(s, jp2)  # opj_jp2_end_decompress reads the boxes after
    if mode in ("LA", "PA", "RGB", "RGBA", "CMYK"):
        pixels = image if mode in ("RGBA", "CMYK") else \
            image[..., [0, 3]] if mode in ("LA", "PA") else image[..., :3]
    else:
        pixels = image
    table = palette.table() if palette is not None else \
        (np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
         if mode in ("P", "PA") else None)
    return _mode_to_rgb(mode, pixels, table), None, None
