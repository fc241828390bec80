// The JPEG scan decoders of the upload decoder
// (ecgmm_torch/serve/imdecode.py), as libjpeg-turbo 3.1 decodes scans under
// Pillow: Huffman-coded sequential (jdhuff.c) and progressive (jdphuff.c)
// scans and arithmetic-coded ones (SOF9, SOF10: jdarith.c) fill the same
// int16 coefficient planes (natural order, 64 a block), whose IDCT,
// upsampling and colour conversion (imdecode.cpp) are shared; lossless
// scans (SOF3: jdlhuff.c, jddiffct.c, jdlossls.c) write 8-bit samples,
// which go to the upsampling and colour conversion with no IDCT.
//
// Corrupt and cut files come out of libjpeg's readers, not of the codes,
// so the readers are libjpeg's. The Huffman bit reader's slow path fills
// a 64-bit buffer to at least 57 bits whenever a read runs short; a
// marker met in the data ends the filling, after which reads get zero
// bits and, once one needs a bit the data did not hold, libjpeg's
// "insufficient data" state leaves the rest of the restart interval
// untouched (zero blocks; in a lossless scan, zero differences from a
// reset prediction); a code longer than 16 bits decodes as 0 after 17
// bits. A fill that runs past the end of the file is where libjpeg
// suspends and Pillow, with nothing more to hand it, refuses the file
// ("image file is truncated").
//
// Pillow hands libjpeg 64 KiB a call, but that changes nothing for the
// Huffman readers: libjpeg suspends an MCU that runs past what it holds
// and decodes it anew from the same state when Pillow calls again.
// jdhuff.c's fast path (6 bytes at a time, taken while 512 bytes a block
// remain) fills the buffer otherwise, but after the slow path's next fill
// the buffer ends at the first byte boundary 57 bits past the bits
// consumed whatever came before, and an MCU that meets a marker is decoded
// again by the slow path; so the bits, the markers met and the end are the
// slow path's, and the decoders here take it always.
//
// The arithmetic decoder (T.81 Annex D's QM decoder, arith_decode) cannot
// suspend: it reads byte by byte and fails when the source runs dry, so
// its entry point reports how far it read, and the caller refuses a file
// of which Pillow hands libjpeg too little at once. Corrupt data is no
// error there: as libjpeg warns ("bad arithmetic code"), the decoder stops
// filling blocks until the next restart marker.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  ERR_BAD_HUFFMAN_TABLE = -1,
  ERR_RAN_DRY = -7,  // a byte past the end of the file was needed
  ERR_BAD_DC = -8,  // a progressive DC value past 32 bits (JERR_BAD_DCT_COEF)
};

constexpr int kMinGetBits = 57;  // BIT_BUF_SIZE - 7
constexpr int kLookahead = 8;    // HUFF_LOOKAHEAD
constexpr int kDcStatBins = 64;
constexpr int kAcStatBins = 256;

// zigzag position -> natural position; the 16 extra entries absorb a run
// past the 63rd coefficient in corrupt data, as jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jaricom.c: T.81 Table D.2, each entry Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; the last is the fixed estimate of 0.5
// that libjpeg codes sign bits and refinements with (T.851 Table 5).
#define V(i, qe, nlps, nmps, sw) \
  ((int32_t(qe) << 16) | (int32_t(nmps) << 8) | (int32_t(sw) << 7) | (nlps))
const int32_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),      V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),      V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),    V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),    V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),    V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),    V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),    V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),    V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),    V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),    V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),    V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),    V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),    V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),    V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),    V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),    V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),   V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0),  V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// libjpeg's data source and marker reader as the scan decoders see them:
// bytes one at a time, a marker met in the data kept as unread_marker, the
// RSTn markers read and resynchronised as jdmarker.c's read_restart_marker
// and jpeg_resync_to_restart do. `dry`: a read ran past the end of the
// file, where libjpeg suspends (Huffman) or fails (arithmetic) and Pillow,
// with nothing more to hand it, refuses the file.
struct Source {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;
  int unread_marker = 0;
  int64_t marker_pos = -1;  // the 0xFF before unread_marker's code
  int next_restart_num = 0;
  bool dry = false;
  // old-style JPEG-in-TIFF: libtiff's source answers a resynchronisation
  // with an error, which ends the decoding like running dry
  bool strict_resync = false;

  int byte() {
    if (pos >= len) {
      dry = true;
      return -1;
    }
    return buf[pos++];
  }
  // next_marker: skip to 0xFF, swallow fill bytes, skip a stuffed 0xFF00
  bool next_marker() {
    for (;;) {
      int c = byte();
      while (c >= 0 && c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c < 0) return false;
      if (c != 0) {
        unread_marker = c;
        marker_pos = pos - 2;
        return true;
      }
    }
  }
  bool resync(int desired) {
    int marker = unread_marker;
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;  // invalid marker
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;  // valid non-restart marker
      } else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;  // one of the next two expected restarts
      } else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;  // a prior restart, so advance
      } else {
        action = 1;  // desired restart or too far away
      }
      if (action == 1) {
        unread_marker = 0;
        return true;
      }
      if (action == 3) return true;
      if (!next_marker()) return false;
      marker = unread_marker;
    }
  }
  // false where the file ends first
  bool read_restart_marker() {
    if (unread_marker == 0 && !next_marker()) return false;
    if (unread_marker == 0xD0 + next_restart_num) {
      unread_marker = 0;
    } else if (strict_resync) {
      dry = true;
      return false;
    } else if (!resync(next_restart_num)) {
      return false;
    }
    next_restart_num = (next_restart_num + 1) & 7;
    return true;
  }
};

// jdhuff.c jpeg_make_d_derived_tbl
struct Table {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  int32_t lookup[1 << kLookahead];  // nb << 8 | value; nb 9: longer

  bool build(const uint8_t* bits, const uint8_t* vals) {
    uint8_t size[257];
    int32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (p + bits[l] > 256) return false;
      for (int i = 0; i < bits[l]; ++i) size[p++] = uint8_t(l);
    }
    size[p] = 0;
    int32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (int32_t(1) << si)) return false;
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - code_of[p];
        p += bits[l];
        maxcode[l] = code_of[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(huffval, vals, 256);
    for (int i = 0; i < (1 << kLookahead); ++i)
      lookup[i] = (kLookahead + 1) << kLookahead;
    p = 0;
    for (int l = 1; l <= kLookahead; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        int look = code_of[p] << (kLookahead - l);
        for (int n = 1 << (kLookahead - l); n > 0; --n)
          lookup[look++] = (l << kLookahead) | huffval[p];
      }
    }
    return true;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// libjpeg's Huffman bit reader (jdhuff.c) on the source
struct Bits : Source {
  uint64_t buffer = 0;
  int left = 0;
  bool insufficient = false;

  // jpeg_fill_bit_buffer; past the end of the file it pads, and the
  // caller refuses the file
  void fill(int nbits) {
    while (unread_marker == 0 && !dry && left < kMinGetBits) {
      int c = byte();
      if (c < 0) break;
      if (c == 0xFF) {
        do c = byte();
        while (c == 0xFF);
        if (c < 0) break;
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_marker = c;
          marker_pos = pos - 2;
          break;
        }
      }
      buffer = (buffer << 8) | uint64_t(c);
      left += 8;
    }
    if ((unread_marker || dry) && nbits > left) {
      insufficient = insufficient || unread_marker;
      buffer <<= kMinGetBits - left;
      left = kMinGetBits;
    }
  }
  void check(int nbits) {
    if (left < nbits) fill(nbits);
  }
  int get(int n) {
    left -= n;
    return int((buffer >> left) & ((uint64_t(1) << n) - 1));
  }
  int peek(int n) const {
    return int((buffer >> (left - n)) & ((uint64_t(1) << n) - 1));
  }

  // HUFF_DECODE and jpeg_huff_decode
  int decode(const Table& t) {
    int nb = 1;
    if (left < kLookahead) {
      fill(0);
      if (left < kLookahead) return slow(t, nb);
    }
    const int look = peek(kLookahead);
    nb = t.lookup[look] >> kLookahead;
    if (nb <= kLookahead) {
      left -= nb;
      return t.lookup[look] & ((1 << kLookahead) - 1);
    }
    return slow(t, nb);
  }
  int slow(const Table& t, int l) {
    check(l);
    int32_t code = get(l);
    while (code > t.maxcode[l]) {
      code <<= 1;
      check(1);
      code |= get(1);
      ++l;
    }
    if (l > 16) return 0;  // libjpeg: "corrupt JPEG data", a fake zero
    return t.huffval[(code + t.valoffset[l]) & 0xFF];
  }
  // DC difference or AC value of s extra bits
  int value(int s) {
    check(s);
    return extend(get(s), s);
  }

  // process_restart's marker part: the buffered bits dropped, RSTn read;
  // false where the file ends first
  bool restart() {
    left = 0;
    if (!read_restart_marker()) return false;
    if (unread_marker == 0) insufficient = false;
    return true;
  }
};

struct Arith {
  Source src;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: read 2 bytes first; -1: corrupt data, skip
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  int byte_in() {
    if (src.unread_marker) return 0;
    int data = src.byte();
    if (data == 0xFF) {
      do data = src.byte();
      while (data == 0xFF);
      if (data == 0) {
        data = 0xFF;
      } else if (data > 0) {
        src.unread_marker = data;
        src.marker_pos = src.pos - 2;
        data = 0;
      }
    }
    return data < 0 ? 0 : data;  // past the end: the caller refuses
  }

  // jdarith.c arith_decode: one binary decision with the statistics bin st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte_in();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // got the 2 initial bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct ArithScan {
  int n_comp;
  const int32_t* comp;  // per component: h, v, DC, AC table (0-15), stride
  int16_t* coef;
  const int64_t* coef_off;
  int mcus_x, mcus_y, restart_interval;
  int ss, se, ah, al;
  bool progressive;
  const uint8_t* dc_l;
  const uint8_t* dc_u;
  const uint8_t* ac_k;
};

class ArithDecoder {
 public:
  ArithDecoder(const ArithScan& s, const uint8_t* buf, int64_t len,
               int64_t pos)
      : s_(s) {
    ar_.src = Source{buf, len, pos};
    std::memset(dc_stats_, 0, sizeof(dc_stats_));
    std::memset(ac_stats_, 0, sizeof(ac_stats_));
    std::memset(last_dc_, 0, sizeof(last_dc_));
    std::memset(dc_context_, 0, sizeof(dc_context_));
    restarts_to_go_ = s.restart_interval;
  }

  int run(int64_t* out) {
    for (int my = 0; my < s_.mcus_y; ++my) {
      for (int mx = 0; mx < s_.mcus_x; ++mx) {
        mcu(my, mx);
        if (ar_.src.dry) return ERR_RAN_DRY;
      }
    }
    const Source& src = ar_.src;
    out[0] = src.unread_marker ? src.marker_pos : src.pos;  // marker reader
    out[1] = src.pos;  // bytes read
    return 0;
  }

 private:
  const ArithScan& s_;
  Arith ar_;
  uint8_t dc_stats_[16][kDcStatBins];
  uint8_t ac_stats_[16][kAcStatBins];
  int last_dc_[4];
  int dc_context_[4];
  unsigned restarts_to_go_;

  bool uses_dc() const { return !s_.progressive || (s_.ss == 0 && s_.ah == 0); }
  bool uses_ac() const { return !s_.progressive || s_.ss != 0; }

  // jdarith.c process_restart
  void restart() {
    if (!ar_.src.read_restart_marker()) return;  // dry: the caller stops
    for (int c = 0; c < s_.n_comp; ++c) {
      const int32_t* cp = s_.comp + 5 * c;
      if (uses_dc()) {
        std::memset(dc_stats_[cp[2]], 0, kDcStatBins);
        last_dc_[c] = 0;
        dc_context_[c] = 0;
      }
      if (uses_ac()) std::memset(ac_stats_[cp[3]], 0, kAcStatBins);
    }
    ar_.reset();
    restarts_to_go_ = s_.restart_interval;
  }

  // Figures F.19-F.24: a DC difference; false on a magnitude overflow
  bool dc_diff(int c, int tbl, int* diff) {
    uint8_t* st = dc_stats_[tbl] + dc_context_[c];
    if (ar_.decode(st) == 0) {
      dc_context_[c] = 0;
      *diff = 0;
      return true;
    }
    const int sign = ar_.decode(st + 1);
    st += 2 + sign;
    int m = ar_.decode(st);
    if (m != 0) {
      st = dc_stats_[tbl] + 20;
      while (ar_.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < int((1L << s_.dc_l[tbl]) >> 1))
      dc_context_[c] = 0;
    else if (m > int((1L << s_.dc_u[tbl]) >> 1))
      dc_context_[c] = 12 + sign * 4;
    else
      dc_context_[c] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar_.decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // The AC coefficients k0..se of a block (F.20), scaled by al; false on
  // a spectral or magnitude overflow
  bool ac_first(int16_t* blk, int tbl, int k0) {
    const int se = s_.progressive ? s_.se : 63;
    for (int k = k0; k <= se; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (ar_.decode(st)) break;  // EOB
      while (ar_.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      const int sign = ar_.decode(ar_.fixed_bin);
      st += 2;
      int m = ar_.decode(st);
      if (m != 0) {
        if (ar_.decode(st)) {
          m <<= 1;
          st = ac_stats_[tbl] + (k <= s_.ac_k[tbl] ? 189 : 217);
          while (ar_.decode(st)) {
            if ((m <<= 1) == 0x8000) return false;
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar_.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(unsigned(v) << (s_.progressive ? s_.al : 0));
    }
    return true;
  }

  // decode_mcu_AC_refine; false on a spectral overflow
  bool ac_refine(int16_t* blk, int tbl) {
    const int p1 = 1 << s_.al, m1 = -(1 << s_.al);
    int kex = s_.se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = s_.ss; k <= s_.se; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && ar_.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coefp = blk + kNatural[k];
        if (*coefp) {
          if (ar_.decode(st + 2))
            *coefp = int16_t(*coefp < 0 ? *coefp + m1 : *coefp + p1);
          break;
        }
        if (ar_.decode(st + 1)) {
          *coefp = int16_t(ar_.decode(ar_.fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > s_.se) return false;
      }
    }
    return true;
  }

  void mcu(int my, int mx) {
    if (s_.restart_interval) {
      if (restarts_to_go_ == 0) restart();
      --restarts_to_go_;
    }
    if (ar_.src.dry || ar_.ct == -1) return;  // -1: skip to the restart
    for (int c = 0; c < s_.n_comp; ++c) {
      const int32_t* cp = s_.comp + 5 * c;
      const int h = cp[0], v = cp[1], stride = cp[4];
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < h; ++bx) {
          const int64_t row = int64_t(my) * v + by;
          const int64_t col = int64_t(mx) * h + bx;
          int16_t* blk = s_.coef + s_.coef_off[c] + (row * stride + col) * 64;
          if (!block(c, cp, blk)) {
            ar_.ct = -1;  // libjpeg: "bad arithmetic code", skip
            return;
          }
        }
      }
    }
  }

  bool block(int c, const int32_t* cp, int16_t* blk) {
    if (!s_.progressive) {  // decode_mcu: the block whole
      std::memset(blk, 0, 64 * sizeof(int16_t));
      int diff;
      if (!dc_diff(c, cp[2], &diff)) return false;
      last_dc_[c] = (last_dc_[c] + diff) & 0xFFFF;
      blk[0] = int16_t(last_dc_[c]);
      return ac_first(blk, cp[3], 1);
    }
    if (s_.ss == 0) {
      if (s_.ah == 0) {  // decode_mcu_DC_first
        int diff;
        if (!dc_diff(c, cp[2], &diff)) return false;
        last_dc_[c] = (last_dc_[c] + diff) & 0xFFFF;
        blk[0] = int16_t(unsigned(last_dc_[c]) << s_.al);
      } else if (ar_.decode(ar_.fixed_bin)) {  // decode_mcu_DC_refine
        blk[0] = int16_t(blk[0] | (1 << s_.al));
      }
      return true;
    }
    if (s_.ah == 0) return ac_first(blk, cp[3], s_.ss);
    return ac_refine(blk, cp[3]);
  }
};

struct LossyScan {
  int n_comp;
  const int32_t* comp;  // per component: h, v, DC table, AC table, stride
  int16_t* coef;
  const int64_t* coef_off;
  int mcus_x, mcus_y, restart_interval;
  bool progressive;
  int ss, se, ah, al;
  int blocks_in_mcu;
  int imcu_v;  // MCU rows an iMCU row (a single component's v, else 1)
};

class LossyDecoder {
 public:
  LossyDecoder(const LossyScan& s, Bits& br, const Table* tables)
      : s_(s), br_(br), t_(tables) {}

  // jdcoefct.c's last_good_iMCU_row: the last iMCU row in which an MCU
  // began with data left (the smoothing of rows after it uses the
  // coefficient bits of the scans before this one)
  int last_good = -1;
  // the iMCU row in which the data ran out
  int dry_row = -1;

  int run() {
    unsigned restarts_to_go = s_.restart_interval;
    std::vector<int16_t*> blocks;
    std::vector<int> comp_of;
    for (int my = 0; my < s_.mcus_y; ++my) {
      for (int mx = 0; mx < s_.mcus_x; ++mx) {
        blocks.clear();
        comp_of.clear();
        for (int c = 0; c < s_.n_comp; ++c) {
          const int32_t* cp = s_.comp + 5 * c;
          for (int by = 0; by < cp[1]; ++by)
            for (int bx = 0; bx < cp[0]; ++bx) {
              const int64_t row = int64_t(my) * cp[1] + by;
              const int64_t col = int64_t(mx) * cp[0] + bx;
              blocks.push_back(s_.coef + s_.coef_off[c] +
                               (row * cp[4] + col) * 64);
              comp_of.push_back(c);
            }
        }
        if (!br_.insufficient) last_good = my / s_.imcu_v;
        if (s_.restart_interval && restarts_to_go == 0) {
          if (!br_.restart()) {
            dry_row = my / s_.imcu_v;
            return ERR_RAN_DRY;
          }
          std::memset(last_dc_, 0, sizeof(last_dc_));
          eobrun_ = 0;
          restarts_to_go = s_.restart_interval;
        }
        mcu(blocks, comp_of);
        if (bad_dc_) return ERR_BAD_DC;
        if (br_.dry) {
          dry_row = my / s_.imcu_v;
          return ERR_RAN_DRY;
        }
        if (s_.restart_interval) --restarts_to_go;
      }
    }
    return 0;
  }

 private:
  const LossyScan& s_;
  Bits& br_;
  const Table* t_;
  int last_dc_[4] = {0, 0, 0, 0};
  int64_t eobrun_ = 0;
  bool bad_dc_ = false;

  void mcu(const std::vector<int16_t*>& blocks,
           const std::vector<int>& comp_of) {
    if (!s_.progressive) return mcu_sequential(blocks, comp_of);
    if (s_.ss == 0 && s_.ah != 0) {  // DC refinement: no out-of-data check
      const int p1 = 1 << s_.al;
      for (int16_t* blk : blocks) {
        br_.check(1);
        if (br_.get(1)) blk[0] = int16_t(blk[0] | p1);
      }
      return;
    }
    if (br_.insufficient) return;  // leave the MCU as it is
    if (s_.ss == 0) {  // DC first
      for (size_t b = 0; b < blocks.size(); ++b) {
        const int c = comp_of[b];
        int s = br_.decode(t_[s_.comp[5 * c + 2]]);
        if (s) s = br_.value(s);
        const int64_t dc = int64_t(last_dc_[c]) + s;
        if (dc != int32_t(dc)) {  // libjpeg raises
          bad_dc_ = true;
          return;
        }
        last_dc_[c] = int(dc);
        blocks[b][0] = int16_t(unsigned(dc) << s_.al);
      }
      return;
    }
    int16_t* blk = blocks[0];
    const Table& ac = t_[4 + s_.comp[3]];
    if (s_.ah == 0) {  // AC first
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = s_.ss; k <= s_.se; ++k) {
        int s = br_.decode(ac);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(unsigned(br_.value(s)) << s_.al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = int64_t(1) << r;
          if (r) {
            br_.check(r);
            eobrun_ += br_.get(r);
          }
          --eobrun_;
          break;
        }
      }
      return;
    }
    // AC refinement
    const int p1 = 1 << s_.al, m1 = -(1 << s_.al);
    int k = s_.ss;
    auto correct = [&](int16_t* coefp) {
      br_.check(1);
      if (br_.get(1) && (*coefp & p1) == 0)
        *coefp = int16_t(*coefp >= 0 ? *coefp + p1 : *coefp + m1);
    };
    if (eobrun_ == 0) {
      for (; k <= s_.se; ++k) {
        int s = br_.decode(ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          br_.check(1);
          s = br_.get(1) ? p1 : m1;  // libjpeg warns where the size is not 1
        } else if (r != 15) {
          eobrun_ = int64_t(1) << r;
          if (r) {
            br_.check(r);
            eobrun_ += br_.get(r);
          }
          break;
        }
        do {
          int16_t* coefp = blk + kNatural[k];
          if (*coefp != 0) {
            correct(coefp);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= s_.se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= s_.se; ++k) {
        int16_t* coefp = blk + kNatural[k];
        if (*coefp != 0) correct(coefp);
      }
      --eobrun_;
    }
  }

  // jdhuff.c decode_mcu: the blocks start from zero; out of data, they
  // stay so
  void mcu_sequential(const std::vector<int16_t*>& blocks,
                      const std::vector<int>& comp_of) {
    for (int16_t* blk : blocks) std::memset(blk, 0, 64 * sizeof(int16_t));
    if (br_.insufficient) return;
    for (size_t b = 0; b < blocks.size(); ++b) {
      const int c = comp_of[b];
      const int32_t* cp = s_.comp + 5 * c;
      int16_t* blk = blocks[b];
      int s = br_.decode(t_[cp[2]]);
      if (s) s = br_.value(s);
      last_dc_[c] = int(unsigned(s) + unsigned(last_dc_[c]));
      blk[0] = int16_t(last_dc_[c]);
      const Table& ac = t_[4 + cp[3]];
      for (int k = 1; k < 64; ++k) {
        s = br_.decode(ac);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(br_.value(s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }
};

// One row of jdlossls.c's undifferencing: `first` rows predict from the
// left (the first sample by `initial`), the others from above (the first
// sample) and by predictor psv (the rest).
void undifference(const int32_t* diff, const int32_t* prev, int32_t* out,
                  int64_t width, bool first, int psv, int initial) {
  if (first) {
    int ra = (diff[0] + initial) & 0xFFFF;
    out[0] = ra;
    for (int64_t x = 1; x < width; ++x) out[x] = ra = (diff[x] + ra) & 0xFFFF;
    return;
  }
  int rb = prev[0];
  int ra = (diff[0] + rb) & 0xFFFF;
  out[0] = ra;
  for (int64_t x = 1; x < width; ++x) {
    const int rc = rb;
    rb = prev[x];
    int p;
    switch (psv) {
      case 1: p = ra; break;
      case 2: p = rb; break;
      case 3: p = rc; break;
      case 4: p = ra + rb - rc; break;
      case 5: p = ra + ((rb - rc) >> 1); break;
      case 6: p = rb + ((ra - rc) >> 1); break;
      default: p = (ra + rb) >> 1; break;
    }
    out[x] = ra = (diff[x] + p) & 0xFFFF;
  }
}

bool build_tables(Table* tables, const uint8_t* huff_bits,
                  const uint8_t* huff_vals, const bool* used) {
  for (int t = 0; t < 8; ++t)
    if (used[t] && !tables[t].build(huff_bits + 17 * t, huff_vals + 256 * t))
      return false;
  return true;
}

// out[0]: the offset where the marker reader resumes
void report(const Bits& br, int64_t* out) {
  out[0] = br.unread_marker ? br.marker_pos : br.pos;
}

int huffman_scan(const uint8_t* buf, int64_t len, int64_t pos, int n_comp,
                 const int32_t* comp, int16_t* coef, const int64_t* coef_off,
                 int mcus_x, int mcus_y, int restart_interval,
                 int progressive, int ss, int se, int ah, int al,
                 const uint8_t* huff_bits, const uint8_t* huff_vals,
                 int imcu_v, int64_t* out, bool strict_resync) {
  Table tables[8];
  bool used[8] = {false};
  for (int c = 0; c < n_comp; ++c) {
    if (!progressive || (ss == 0 && ah == 0)) used[comp[5 * c + 2]] = true;
    if (!progressive || ss > 0) used[4 + comp[5 * c + 3]] = true;
  }
  if (!build_tables(tables, huff_bits, huff_vals, used))
    return ERR_BAD_HUFFMAN_TABLE;
  int blocks = 0;
  for (int c = 0; c < n_comp; ++c) blocks += comp[5 * c] * comp[5 * c + 1];
  LossyScan s{n_comp,   comp, coef, coef_off, mcus_x, mcus_y,
              restart_interval, progressive != 0, ss, se, ah, al, blocks,
              imcu_v};
  Bits br{buf, len, pos};
  br.strict_resync = strict_resync;
  LossyDecoder d(s, br, tables);
  const int rc = d.run();
  if (rc == ERR_RAN_DRY) out[1] = d.dry_row;
  if (rc) return rc;
  report(br, out);
  out[1] = d.last_good;
  return 0;
}

}  // namespace

extern "C" {


// Decode one Huffman-coded lossy scan into the quantised coefficients of
// its components (natural order, 64 int16 a block), as libjpeg does.
//   buf, len, pos: the file and the offset of the scan's first data byte
//   n_comp: components in the scan (1 to 4)
//   comp: per component 5 ints: h, v (blocks per MCU; 1, 1 in a
//     single-component scan), DC table, AC table (0-3), blocks per row of
//     its coefficient plane
//   coef, coef_off: the int16 coefficient buffer and each component's
//     offset (in int16 elements) into it
//   mcus_x, mcus_y: MCUs across and down the scan
//   restart_interval: MCUs between restart markers (0: none)
//   progressive: 0 for a sequential scan; else the spectral band ss..se
//     (zigzag) and successive approximation ah, al of a progressive one:
//     ss == 0 a DC scan (ah == 0: the difference shifted left by al; else
//     bit al appended), ss > 0 an AC scan of one component (ah == 0: the
//     band's first bits with end-of-band runs; else refinement)
//   huff_bits: 8 tables (DC 0-3, AC 0-3) x 17 code-length counts (index 0
//     unused); huff_vals: 8 x 256 symbols
//   imcu_v: MCU rows an iMCU row (a single-component scan's v, else 1)
//   out: [0] the offset where the marker reader resumes, [1] the last
//     iMCU row in which an MCU began with data left (where the scan ran
//     dry: the iMCU row it ran dry in)
// Returns ERR_RAN_DRY where the scan needs bytes past the end of the file
// (before a marker), ERR_BAD_DC where a progressive DC value leaves 32 bits.
int ecgmm_jpeg_huffman_scan(const uint8_t* buf, int64_t len, int64_t pos,
                            int n_comp, const int32_t* comp, int16_t* coef,
                            const int64_t* coef_off, int mcus_x, int mcus_y,
                            int restart_interval, int progressive, int ss,
                            int se, int ah, int al, const uint8_t* huff_bits,
                            const uint8_t* huff_vals, int imcu_v,
                            int64_t* out) {
  return huffman_scan(buf, len, pos, n_comp, comp, coef, coef_off, mcus_x,
                      mcus_y, restart_interval, progressive, ss, se, ah, al,
                      huff_bits, huff_vals, imcu_v, out, false);
}

// The same, where a restart marker out of sequence fails as running dry
// does (old-style JPEG-in-TIFF, whose libtiff source cannot resynchronise)
int ecgmm_jpeg_huffman_scan_strict(
    const uint8_t* buf, int64_t len, int64_t pos, int n_comp,
    const int32_t* comp, int16_t* coef, const int64_t* coef_off, int mcus_x,
    int mcus_y, int restart_interval, int progressive, int ss, int se, int ah,
    int al, const uint8_t* huff_bits, const uint8_t* huff_vals, int imcu_v,
    int64_t* out) {
  return huffman_scan(buf, len, pos, n_comp, comp, coef, coef_off, mcus_x,
                      mcus_y, restart_interval, progressive, ss, se, ah, al,
                      huff_bits, huff_vals, imcu_v, out, true);
}

// Decode one lossless scan into 8-bit sample planes.
//   buf, len, pos: the file and the offset of the scan's first data byte
//   n_comp: components in the scan (1 to 4)
//   comp: per component 6 int64: h, v (its sampling factors), DC table
//     (0-3), width and height (the component's samples: width_in_blocks,
//     height_in_blocks), offset of its plane in `planes`
//   planes, stride: the output samples, `stride` bytes a row
//   mcus_x: MCUs across the scan; imcu_rows: the frame's iMCU rows
//   restart_interval: MCUs between restart markers, a multiple of mcus_x
//   psv, pt: the predictor (1-7) and the point transform
//   huff_bits, huff_vals: as for ecgmm_jpeg_huffman_scan (DC tables 0-3)
//   out: [0] the offset where the marker reader resumes
// Returns ERR_RAN_DRY where the bit reader runs past the end of the file
// before it met a marker.
int ecgmm_jpeg_lossless_scan(const uint8_t* buf, int64_t len, int64_t pos,
                             int n_comp, const int64_t* comp,
                             uint8_t* planes, int64_t stride, int mcus_x,
                             int imcu_rows, int restart_interval, int psv,
                             int pt, const uint8_t* huff_bits,
                             const uint8_t* huff_vals, int64_t* out) {
  Table tables[8];
  bool used[8] = {false};
  for (int c = 0; c < n_comp; ++c) used[comp[6 * c + 2]] = true;
  if (!build_tables(tables, huff_bits, huff_vals, used))
    return ERR_BAD_HUFFMAN_TABLE;
  Bits br{buf, len, pos};
  const bool interleaved = n_comp > 1;
  const int initial = 1 << (8 - pt - 1);
  // per component: v rows of differences (an MCU row's, MCUs_per_row
  // MCUs of mw samples wide) and of undifferenced samples, the last of the
  // latter the row above the next iMCU row
  std::vector<std::vector<int32_t>> diff(n_comp), undiff(n_comp);
  int64_t mw[4], mh[4];
  bool first_row[4] = {true, true, true, true};
  for (int c = 0; c < n_comp; ++c) {
    const int64_t v = comp[6 * c + 1];
    mw[c] = interleaved ? comp[6 * c] : 1;
    mh[c] = interleaved ? v : 1;
    diff[c].assign(size_t(v * mcus_x * mw[c]), 0);
    undiff[c].assign(size_t(v * comp[6 * c + 3]), 0);
  }
  int rows_to_go = restart_interval ? restart_interval / mcus_x : 0;
  for (int row_i = 0; row_i < imcu_rows; ++row_i) {
    const bool last = row_i == imcu_rows - 1;
    // an interleaved iMCU row is one MCU row; a single component's has v
    // (fewer at the bottom) rows of one-sample MCUs
    int mcu_rows = 1;
    if (!interleaved) {
      const int64_t v = comp[1], height = comp[4];
      mcu_rows = int(last ? (height % v ? height % v : v) : v);
    }
    for (int y = 0; y < mcu_rows; ++y) {
      if (restart_interval && rows_to_go == 0) {  // jddiffct.c
        if (!br.restart()) return ERR_RAN_DRY;
        for (bool& f : first_row) f = true;
        rows_to_go = restart_interval / mcus_x;
      }
      if (br.insufficient) {  // jdlhuff.c decode_mcus, out of data
        for (int c = 0; c < n_comp; ++c) {
          const int64_t w = int64_t(mcus_x) * mw[c];
          std::memset(diff[c].data() + y * w, 0,
                      size_t(mh[c] * w) * sizeof(int32_t));
        }
        for (bool& f : first_row) f = true;
      } else {
        for (int mx = 0; mx < mcus_x; ++mx) {
          for (int c = 0; c < n_comp; ++c) {
            const int64_t w = int64_t(mcus_x) * mw[c];
            const Table& t = tables[comp[6 * c + 2]];
            for (int64_t r = 0; r < mh[c]; ++r) {
              int32_t* d = diff[c].data() + (y + r) * w + mx * mw[c];
              for (int64_t x = 0; x < mw[c]; ++x) {
                const int s = br.decode(t);
                d[x] = s == 16 ? 32768 : s ? br.value(s) : 0;
              }
            }
          }
        }
      }
      if (restart_interval) --rows_to_go;
      if (br.dry) return ERR_RAN_DRY;
    }
    for (int c = 0; c < n_comp; ++c) {
      const int64_t* cp = comp + 6 * c;
      const int64_t v = cp[1], width = cp[3], height = cp[4];
      const int64_t rows = last ? (height % v ? height % v : v) : v;
      for (int64_t r = 0; r < rows; ++r) {
        const int32_t* prev = undiff[c].data() + (r ? r - 1 : v - 1) * width;
        int32_t* u = undiff[c].data() + r * width;
        undifference(diff[c].data() + r * int64_t(mcus_x) * mw[c], prev, u,
                     width, first_row[c], psv, initial);
        first_row[c] = false;
        uint8_t* o = planes + cp[5] + (int64_t(row_i) * v + r) * stride;
        for (int64_t x = 0; x < width; ++x) o[x] = uint8_t(u[x] << pt);
      }
    }
  }
  report(br, out);
  return 0;
}

// Decode one arithmetic-coded scan into the quantised coefficients of its
// components. Arguments as for ecgmm_jpeg_huffman_scan (a sequential
// scan's ss, se, ah, al ignored, as libjpeg ignores them with a warning;
// its 16 tables numbered 0-15), but for the Huffman tables:
//   dc_l, dc_u, ac_k: the 16 conditioning tables (DAC; defaults 0, 1, 5)
//   out: [0] the offset where the marker reader resumes (the 0xFF of a
//     marker the decoder ran into, else the first byte it left unread),
//     [1] the offset after the last byte it read
// Returns ERR_RAN_DRY where the scan needs bytes past the end of the file.
int ecgmm_jpeg_arith_scan(const uint8_t* buf, int64_t len, int64_t pos,
                          int n_comp, const int32_t* comp, int16_t* coef,
                          const int64_t* coef_off, int mcus_x, int mcus_y,
                          int restart_interval, int progressive, int ss,
                          int se, int ah, int al, const uint8_t* dc_l,
                          const uint8_t* dc_u, const uint8_t* ac_k,
                          int64_t* out) {
  ArithScan s{n_comp, comp, coef, coef_off, mcus_x, mcus_y,
              restart_interval, ss, se, ah, al, progressive != 0,
              dc_l, dc_u, ac_k};
  ArithDecoder d(s, buf, len, pos);
  return d.run(out);
}

// The entries of jaricom.c's table, for a test against libjpeg's own.
int ecgmm_jpeg_aritab(int32_t* out) {
  std::memcpy(out, kAritab, sizeof(kAritab));
  return 0;
}

}  // extern "C"
