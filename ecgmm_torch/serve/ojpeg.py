"""Old-style JPEG-in-TIFF (compression 6) as libtiff 4.7's tif_ojpeg.c
reads it under Pillow.

libtiff rebuilds one JPEG stream for the whole image and decodes it with
libjpeg: its input is the JPEGInterchangeFormat region (where the tag is
set) followed by every strip's bytes; the markers at its start (SOI, APPn,
COM, DQT, DHT, DRI, SOF0, SOF1 or SOF3, then SOS) give the tables, the
frame and the scan, else (the input does not start with a marker) the
JPEGQTables, JPEGDCTables and JPEGACTables tags give the tables and the
directory the frame. It writes SOI, the tables, DRI, SOF and SOS anew,
then the entropy-coded bytes that follow, a restart marker between two
strips and EOI after the last. An image of several strips takes a
restart interval of one strip's MCUs, its strips whole MCU rows.

YCbCr in one plane comes out of libjpeg as raw downsampled planes, which
libtiff packs into TIFF's YCbCr sampling blocks (OJPEGDecodeRaw) for the
RGBA reader to convert (`tiff._rgba_image`); grey and RGB come out as
coded samples. The planes come from the port's JPEG decoder
(`imdecode._decode_jpeg`, whose Huffman scan here fails, as libtiff's
source does, where the data ends or a restart marker is out of
sequence): the strip libjpeg fails in keeps the rows before the failure
and the next one cannot be read at all. libtiff's skips of marker data
stay inside the piece they start in; without StripByteCounts it cannot
read the strips (TIFFReadDirectory leaves old-style JPEG's counts alone).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ecgmm_torch.serve import imdecode
from ecgmm_torch.serve.imdecode import _bad, _unsupported
from ecgmm_torch.serve.wire import BadRequest

# the tags tif_ojpeg.c reads
JPEG_PROC, JIF_OFFSET, JIF_LENGTH, RESTART = 512, 513, 514, 515
Q_TABLES, DC_TABLES, AC_TABLES = 519, 520, 521


class _Input:
    """OJPEG's input buffer: the pieces it reads in order, a byte at a
    time for the header."""

    def __init__(self, pieces: List[Tuple[int, bytes]]):
        self.pieces = pieces  # (strile index or -1 for the JIF, bytes)
        self.i, self.pos = 0, 0

    def byte(self) -> int:
        while self.i < len(self.pieces) and \
                self.pos >= len(self.pieces[self.i][1]):
            self.i, self.pos = self.i + 1, 0
        if self.i >= len(self.pieces):
            raise _bad("old-style JPEG: the data ends inside its header "
                       "(libtiff: premature end)")
        b = self.pieces[self.i][1][self.pos]
        self.pos += 1
        return b

    def peek(self) -> int:
        b = self.byte()
        self.pos -= 1
        return b

    def word(self) -> int:
        return (self.byte() << 8) | self.byte()

    def block(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def skip(self, n: int) -> None:
        """OJPEGReadSkip: at most what is left of the current piece (it
        never skips into the next)."""
        if self.i < len(self.pieces):
            self.pos = min(self.pos + n, len(self.pieces[self.i][1]))


class OldJpeg:
    """The decoded image of an old-style JPEG TIFF, strip by strip."""

    def __init__(self, data: bytes, lt, tags: dict):
        self.lt = lt
        if lt.tiled or lt.planar != 1:
            raise _unsupported("old-style JPEG in tiles or separate planes")
        if lt.spp not in (1, 3):
            raise _bad(f"libtiff: {lt.spp} samples per pixel in old-style "
                       "JPEG")
        self.spp = lt.spp
        self.width = lt.width
        self.rps = min(lt.rps, lt.length)
        self.ycc = lt.photo == 6 and lt.spp == 3
        sub = lt.ycbcr_sub if lt.ycbcr_sub is not None else (2, 2)
        # tif_ojpeg.c keeps the tag's values in bytes
        self.hor, self.ver = (sub[0] & 0xFF, sub[1] & 0xFF) if self.ycc \
            else (1, 1)
        self.restart = tags.get(RESTART) or 0
        pieces = self._pieces(data, tags)
        source = _Input(pieces)
        if self.ycc:
            self._correct_subsampling(pieces)
        if self.rps < lt.length:
            if self.hor not in (1, 2, 4) or self.ver not in (1, 2, 4):
                raise _bad("libtiff: invalid subsampling values")
            if self.rps % (8 * self.ver):
                raise _bad("libtiff: incompatible vertical subsampling and "
                           "strip length")
            self.restart = (-(-self.width // (8 * self.hor))) * (
                self.rps // (8 * self.ver)) & 0xFFFF
        self.q, self.dc, self.ac = {}, {}, {}
        self.sof = None
        self._header(source, data, tags)
        self._decode(self._stream(pieces, source))

    # ------------------------------------------------------------ input

    def _pieces(self, data: bytes, tags: dict):
        """The JIF region (clamped to the file; an offset past it ignored,
        a length of 0 read to the end), then each strip's bytes (an offset
        of 0 or past the file skipped, a count of 0 read to the end).
        Without StripByteCounts libtiff's source fails at the first strip:
        the input ends with the JIF region."""
        size = len(data)
        pieces = []
        jif, length = tags.get(JIF_OFFSET) or 0, tags.get(JIF_LENGTH) or 0
        if jif >= size:
            jif = 0
        if jif:
            if length == 0 or jif + length > size:
                length = size - jif
            pieces.append((-1, data[jif:jif + length]))
        if not self.lt.counts_read:
            return pieces
        for k in range(self.lt.n):
            offset, count = self.lt.offsets[k], self.lt.counts[k]
            chunk = b""
            if offset and offset < size:
                count = size - offset if count == 0 else min(count,
                                                             size - offset)
                chunk = data[offset:offset + count]
            pieces.append((k, chunk))
        return pieces

    def _correct_subsampling(self, pieces) -> None:
        """OJPEGSubsamplingCorrect: a YCbCr image takes the first
        component's sampling of the JPEG frame header, where the input
        starts with one before its scan (this pass reports no error: it
        stops where the real read would fail)."""
        src = _Input(pieces)
        hv = []
        try:
            while src.peek() == 0xFF:
                src.byte()
                m = src.byte()
                while m == 0xFF:
                    m = src.byte()
                if m == 0xD8:
                    continue
                if m in (0xC0, 0xC1, 0xC3):
                    n = src.word()
                    if n < 11 or (n - 8) % 3 or src.byte() != 8:
                        return
                    src.skip(4)
                    if src.byte() != (n - 8) // 3:
                        return
                    for _ in range((n - 8) // 3):
                        src.byte()
                        hv.append(src.byte())
                        src.byte()
                    break
                if m == 0xDD:
                    if src.word() != 4:
                        return
                    self.restart = src.word()
                    continue
                if not (0xE0 <= m <= 0xEF or m in (0xFE, 0xDB, 0xC4)):
                    return
                n = src.word()
                if n < 2 or (n == 2 and m in (0xDB, 0xC4)):
                    return
                src.skip(n - 2)
        except BadRequest:
            pass  # the input ended: the sampling read so far stands
        if hv:
            h, v = hv[0] >> 4, hv[0] & 15
            if h not in (1, 2, 4) or v not in (1, 2, 4) or \
                    any(x != 0x11 for x in hv[1:]):
                raise _unsupported("old-style JPEG whose sampling libtiff "
                                   "leaves to libjpeg")
            self.hor, self.ver = h, v

    # ------------------------------------------------------------ header

    def _header(self, src: _Input, data: bytes, tags: dict) -> None:
        """OJPEGReadHeaderInfoSec: markers up to SOS, else the tables the
        tags point to."""
        m = None
        while src.peek() == 0xFF:
            src.byte()
            m = src.byte()
            while m == 0xFF:
                m = src.byte()
            if m == 0xD8:
                continue
            if 0xE0 <= m <= 0xEF or m == 0xFE:
                n = src.word()
                if n < 2:
                    raise _bad("libtiff: corrupt JPEG data")
                src.skip(n - 2)
            elif m == 0xDD:
                if src.word() != 4:
                    raise _bad("libtiff: corrupt DRI marker")
                self.restart = src.word()
            elif m == 0xDB:
                self._dqt(src)
            elif m == 0xC4:
                self._dht(src)
            elif m in (0xC0, 0xC1, 0xC3):
                self._sof(src, m)
            elif m == 0xDA:
                self._sos(src)
                return
            else:
                raise _bad(f"libtiff: unknown marker 0x{m:02X} in old-style "
                           "JPEG data")
        self._tables(data, tags)

    def _dqt(self, src: _Input) -> None:
        n = src.word()
        if n <= 2:
            raise _bad("libtiff: corrupt DQT marker")
        n -= 2
        while n > 0:
            if n < 65:
                raise _bad("libtiff: corrupt DQT marker")
            body = src.block(65)
            if body[0] & 15 > 3:
                raise _bad("libtiff: corrupt DQT marker")
            self.q[body[0] & 15] = b"\xff\xdb\x00\x43" + body
            n -= 65

    def _dht(self, src: _Input) -> None:
        n = src.word()
        if n <= 2:
            raise _bad("libtiff: corrupt DHT marker")
        body = src.block(n - 2)
        seg = b"\xff\xc4" + struct.pack(">H", n) + body
        kind = body[0]
        if kind & 0xF0 == 0:
            if kind > 3:
                raise _bad("libtiff: corrupt DHT marker")
            self.dc[kind] = seg
        else:
            if kind & 0xF0 != 0x10 or kind & 15 > 3:
                raise _bad("libtiff: corrupt DHT marker")
            self.ac[kind & 15] = seg

    def _sof(self, src: _Input, marker: int) -> None:
        if self.sof is not None:
            raise _bad("libtiff: corrupt JPEG data (a second frame header)")
        n = src.word()
        if n < 11 or (n - 8) % 3:
            raise _bad("libtiff: corrupt SOF marker")
        nc = (n - 8) // 3
        if nc != self.spp:
            raise _bad("libtiff: unexpected number of samples in old-style "
                       "JPEG")
        if src.byte() != 8:
            raise _bad("libtiff: unexpected bits per sample in old-style "
                       "JPEG")
        y, x = src.word(), src.word()
        length, width = self.lt.length, self.width
        if y < length:
            raise _bad("libtiff: old-style JPEG of unexpected height")
        if x < width:
            raise _bad("libtiff: old-style JPEG of unexpected width")
        if x > width:
            raise _bad("libtiff: old-style JPEG wider than the image")
        if src.byte() != nc:
            raise _bad("libtiff: corrupt SOF marker")
        comps = []
        for q in range(nc):
            c, hv, tq = src.byte(), src.byte(), src.byte()
            want = (self.hor << 4) | self.ver if q == 0 else 0x11
            if hv != want:
                raise _bad("libtiff: unexpected subsampling values in "
                           "old-style JPEG")
            comps.append((c, hv, tq))
        self.sof = (marker, y, x, comps)

    def _sos(self, src: _Input) -> None:
        if self.sof is None:
            raise _bad("libtiff: corrupt SOS marker (no frame header)")
        if src.word() != 6 + 2 * self.spp or src.byte() != self.spp:
            raise _bad("libtiff: corrupt SOS marker")
        self.scan = [(src.byte(), src.byte()) for _ in range(self.spp)]
        src.skip(3)  # Ss, Se, Ah and Al, unchecked

    def _tables(self, data: bytes, tags: dict) -> None:
        """The tables of the JPEGQTables, JPEGDCTables and JPEGACTables
        tags (64 quantisation values; 16 counts and their symbols), a
        component reusing the table of the one before where its offset is
        the same or 0; the frame from the directory."""
        spp = self.spp

        def offsets(tag):
            v = tags.get(tag) or ()
            return (list(v) + [0] * spp)[:spp] if len(v) <= 3 else [0] * spp

        def read(at: int, n: int) -> bytes:
            chunk = data[at:at + n]
            if len(chunk) < n:
                raise _bad("libtiff: old-style JPEG tables past the end of "
                           "the file")
            return chunk

        tq, tda = [0] * spp, [0] * spp
        for name, tag in (("Q", Q_TABLES), ("DC", DC_TABLES),
                          ("AC", AC_TABLES)):
            off = offsets(tag)
            if off[0] == 0:
                raise _bad("libtiff: missing old-style JPEG tables")
            for m in range(spp):
                if off[m] and (m == 0 or off[m] != off[m - 1]):
                    if off[m] in off[:max(m - 1, 0)]:
                        raise _bad(f"libtiff: corrupt JPEG {name} tables tag")
                    if name == "Q":
                        self.q[m] = b"\xff\xdb\x00\x43" + bytes([m]) + \
                            read(off[m], 64)
                        tq[m] = m
                    else:
                        counts = read(off[m], 16)
                        total = sum(counts)
                        cls = 0 if name == "DC" else 16
                        seg = b"\xff\xc4" + struct.pack(">H", 19 + total) + \
                            bytes([cls | m]) + counts + read(off[m] + 16,
                                                             total)
                        if name == "DC":
                            self.dc[m] = seg
                            tda[m] = m << 4
                        else:
                            self.ac[m] = seg
                            tda[m] |= m
                else:
                    if name == "Q":
                        tq[m] = tq[m - 1]
                    elif name == "DC":
                        tda[m] = tda[m - 1] & 0xF0
                    else:
                        tda[m] |= tda[m - 1] & 15
        hv = [(self.hor << 4) | self.ver] + [0x11] * (spp - 1)
        self.sof = (0xC0, self.lt.length, self.width,
                    [(m, hv[m], tq[m]) for m in range(spp)])
        self.scan = [(m, tda[m]) for m in range(spp)]

    # ------------------------------------------------------------ stream

    def _stream(self, pieces, src: _Input) -> bytes:
        """OJPEGWriteStream: the header written anew, then the input from
        the scan's first byte, a restart marker after each strip but the
        last and EOI after it (none where the last strip holds nothing:
        there libtiff's source fails)."""
        marker, y, x, comps = self.sof
        out = [b"\xff\xd8"]
        out += [self.q[i] for i in range(4) if i in self.q]
        out += [self.dc[i] for i in range(4) if i in self.dc]
        out += [self.ac[i] for i in range(4) if i in self.ac]
        if self.restart:
            out.append(b"\xff\xdd\x00\x04" + struct.pack(">H",
                                                         self.restart))
        out.append(bytes([0xFF, marker]) + struct.pack(
            ">HBHHB", 8 + 3 * len(comps), 8, y & 0xFFFF, x & 0xFFFF,
            len(comps)) +
            b"".join(bytes(c) for c in comps))
        out.append(b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(self.scan),
                                             len(self.scan)) +
                   b"".join(bytes(s) for s in self.scan) + b"\x00\x3f\x00")
        start_i, start_pos = src.i, src.pos
        rst = 0
        n = self.lt.n
        for i in range(start_i, len(pieces)):
            k, chunk = pieces[i]
            if i == start_i:
                chunk = chunk[start_pos:]
            if not chunk:
                continue
            out.append(chunk)
            if k < 0:
                continue
            if k + 1 < n:
                out.append(bytes([0xFF, 0xD0 + rst]))
                rst = (rst + 1) % 8
            else:
                out.append(b"\xff\xd9")
        return b"".join(out)

    # ------------------------------------------------------------ decode

    def _decode(self, stream: bytes) -> None:
        """libjpeg over the stream: raw planes (YCbCr) or samples; the
        sampling line where its data ran out (libjpeg fails there; None:
        it did not), and the frame libtiff wrote (16 bits a side)."""
        if self.sof[0] == 0xC3:
            raise _bad("libjpeg: raw data cannot be read from a lossless "
                       "JPEG")
        dry = []
        self.planes = imdecode._decode_jpeg(
            stream, imdecode.InTiff("planes" if self.ycc else "raw",
                                    lambda frame: None,
                                    imdecode.jpeg_tables(), dry))
        _, height, width, _ = self.sof
        self.jpeg_height, self.jpeg_width = height & 0xFFFF, width & 0xFFFF
        self.dry_line = dry[0] * 8 if dry else None
        if self.jpeg_width != self.width:
            # OJPEGWriteHeaderInfo: jpeg_start_decompress's image_width
            # must be the strip's (SOF's 16 bits may cut it)
            raise _bad("libtiff: libjpeg returned another image width than "
                       "the old-style JPEG strip's")
        self.cline = -(-self.width // self.hor)

    def strip(self, index: int, out: np.ndarray, rows: int,
              whole: bool = False) -> None:
        """Strip `index` (`rows` rows) into `out` as OJPEGDecode writes it:
        sampling blocks (YCbCr) or samples (`whole`: all the image's rows
        from strip 0, as one strip). Where libjpeg fails inside the strip,
        the rows before are written and BadRequest raised; a strip after
        that cannot be read at all (BadRequest from `unreadable`)."""
        first = index * self.rps // self.ver  # its first sampling line
        lines = -(-rows // self.ver)
        good = lines
        if self.dry_line is not None:
            good = max(0, min(lines, self.dry_line - first))
        if self.ycc:
            self._raw_lines(out, first, good)
        else:
            samples = self.planes
            block = out.reshape(rows, -1)
            part = samples[first:first + good]
            if part.shape[0]:
                block[:part.shape[0], :part[0].size] = part.reshape(
                    part.shape[0], -1)
        if good < lines:
            raise BadRequest("libjpeg runs out of old-style JPEG data")

    def unreadable(self, index: int) -> bool:
        """OJPEGPreDecode cannot skip to this strip: libjpeg failed in a
        strip before it."""
        return self.dry_line is not None and \
            index * self.rps // self.ver > self.dry_line

    def _raw_lines(self, out: np.ndarray, first: int, lines: int) -> None:
        """OJPEGDecodeRaw's packing of `lines` sampling lines from `first`:
        each sampling block hor x ver luma samples then Cb and Cr. libjpeg
        writes no block row past a component's height in blocks, and
        nothing past the frame: those rows of libtiff's iMCU buffer keep
        what the last iMCU row that reached them wrote."""
        if lines <= 0:
            return
        hor, ver, cl = self.hor, self.ver, self.cline
        line = first + np.arange(lines)

        def rows(want, v):
            """The plane rows libjpeg last wrote at these buffer rows."""
            height = -(-(-(-self.jpeg_height * v // ver)) // 8) * 8
            late = np.maximum(want - height + 1, 0)
            return np.maximum(want - -(-late // (8 * v)) * 8 * v, 0)

        luma, cb, cr = self.planes
        ly = rows(line[:, None] * ver + np.arange(ver), ver)
        cy = rows(line, 1)
        lx = np.arange(cl)[:, None] * hor + np.arange(hor)
        y = luma[ly[:, None, :, None], lx[None, :, None, :]]
        packed = np.concatenate([
            y.reshape(lines, cl, hor * ver),
            cb[cy][:, :cl, None], cr[cy][:, :cl, None]], axis=2)
        out[:packed.size] = packed.reshape(-1)
