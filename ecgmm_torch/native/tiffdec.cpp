// Host kernels of the TIFF reader (ecgmm_torch/serve/tiff.py): the strip
// and tile codecs as libtiff 4.7 decodes them under Pillow. PackBits
// (tif_packbits.c), LZW with its old-style bit-reversed ("compat") variant
// (tif_lzw.c), and CCITT modified Huffman RLE, Group 3 (1-D and 2-D) and
// Group 4 (tif_fax3.c, with the state tables mkg3states.c generates). Each
// decodes one strip or tile into a buffer of the size libtiff expects and
// stops there, so no input inflates past it; each returns 0 where libtiff's
// decoder succeeds and ERR_* where it fails (the strip read then fails and
// Pillow refuses the file). Plain C interface, loaded with ctypes; tiff.py
// checks every size before it passes a pointer.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

namespace {

enum {
  ERR_PACKBITS_SHORT = -30,  // "Not enough data for scanline"
  ERR_LZW = -31,             // a code not yet in the table, a bad length
  ERR_LZW_SHORT = -32,       // the data ends before the strip is full
  ERR_FAX = -33,             // premature EOF, a run array overflow, a row
                             // too wide for the run arrays
};

// ---------------------------------------------------------------- LZW

constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kTableSize = ((1 << kBitsMax) - 1) + 1024;  // tif_lzw.c CSIZE

inline int maxcode(int n) { return (1 << n) - 1; }

struct Code {
  int next;          // the entry before this one in the string, -1: none
  uint16_t length;   // the string's length
  uint8_t value;     // its last byte
  uint8_t firstchar; // its first byte
};

// tif_lzw.c LZWDecode (libtiff 4.7): codes MSB first, the width growing
// one code early; the stream must begin with a clear code; a code past
// the table's next entry, or the data running out before `occ` bytes are
// out, fails the strip.
int lzw_new(const uint8_t* bp, int64_t n, uint8_t* op, int64_t occ) {
  std::vector<Code> tab(kTableSize);
  for (int i = 0; i < 256; ++i)
    tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  int64_t pos = 0;
  uint64_t acc = 0;
  int avail = 0;  // bits in acc
  int nbits = kBitsMin;
  int free_ent = -1;  // "dec_codetab - 1": no entry may be added yet
  int maxcodep = maxcode(kBitsMin) - 1;
  int old = 0;
  auto get = [&](int* code) -> bool {
    while (avail < nbits) {
      if (pos >= n) return false;
      acc = (acc << 8) | bp[pos++];
      avail += 8;
    }
    avail -= nbits;
    *code = int((acc >> avail) & uint64_t(maxcode(nbits)));
    return true;
  };
  auto grow = [&]() {
    if (++free_ent > maxcodep) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcodep = maxcode(nbits) - 1;
      if (free_ent >= kTableSize) free_ent = -1;
    }
  };
  while (occ > 0) {
    int code;
    if (!get(&code)) return ERR_LZW_SHORT;
    if (code == kEoi) return ERR_LZW_SHORT;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      maxcodep = maxcode(kBitsMin) - 1;
      do {
        if (!get(&code)) return ERR_LZW_SHORT;
      } while (code == kClear);
      if (code == kEoi) return ERR_LZW_SHORT;
      if (code > kEoi) return ERR_LZW;
      *op++ = uint8_t(code);
      --occ;
      old = code;
      continue;
    }
    if (code < 256) {
      if (code > free_ent) return ERR_LZW;
      Code& e = tab[free_ent];
      e.next = old;
      e.firstchar = tab[old].firstchar;
      e.length = uint16_t(tab[old].length + 1);
      e.value = uint8_t(code);
      grow();
      old = code;
      *op++ = uint8_t(code);
      --occ;
      continue;
    }
    // code >= 258
    if (code >= free_ent) {
      if (code != free_ent) return ERR_LZW;
      tab[free_ent].value = tab[old].firstchar;
    } else {
      tab[free_ent].value = tab[code].firstchar;
    }
    Code& e = tab[free_ent];
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = uint16_t(tab[old].length + 1);
    grow();
    old = code;
    int c = code;
    int64_t len = tab[c].length;
    if (len > occ) {  // only the string's first occ bytes fit
      while (tab[c].length > occ) c = tab[c].next;
      for (int64_t k = occ; k > 0; --k) {
        op[k - 1] = tab[c].value;
        c = tab[c].next;
      }
      return 0;
    }
    for (int64_t k = len; k > 0; --k) {
      op[k - 1] = tab[c].value;
      c = tab[c].next;
    }
    op += len;
    occ -= len;
  }
  return 0;
}

// tif_lzw.c LZWDecodeCompat: the old-style codes, LSB first, the width
// growing when the table passes 2^n - 1; running out of bits reads as EOI.
int lzw_compat(const uint8_t* bp, int64_t n, uint8_t* op, int64_t occ) {
  std::vector<Code> tab(kTableSize);
  for (int i = 0; i < 256; ++i)
    tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  int64_t bitsleft = n * 8, pos = 0;
  uint64_t acc = 0;
  int avail = 0;
  int nbits = kBitsMin;
  int free_ent = -1;
  int maxcodep = maxcode(kBitsMin);
  int old = 0;
  auto next = [&]() -> int {
    if (bitsleft < nbits) return kEoi;
    while (avail < nbits) {
      acc |= uint64_t(bp[pos++]) << avail;
      avail += 8;
    }
    const int code = int(acc & uint64_t(maxcode(nbits)));
    acc >>= nbits;
    avail -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (occ > 0) {
    int code = next();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kTableSize; ++i) tab[i] = {-1, 0, 0, 0};
        nbits = kBitsMin;
        maxcodep = maxcode(kBitsMin);
        code = next();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return ERR_LZW;
      *op++ = uint8_t(code);
      --occ;
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kTableSize) return ERR_LZW;
    Code& e = tab[free_ent];
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = uint16_t(tab[old].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcodep) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcodep = maxcode(nbits);
    }
    old = code;
    if (code >= 256) {
      int c = code;
      if (tab[c].length == 0) return ERR_LZW;
      if (tab[c].length > occ) {
        while (tab[c].length > occ) c = tab[c].next;
        for (int64_t k = occ; k > 0; --k) {
          op[k - 1] = tab[c].value;
          c = tab[c].next;
        }
        occ = 0;
        break;
      }
      const int64_t len = tab[c].length;
      int64_t k = len;
      while (c >= 0 && k > 0) {
        op[--k] = tab[c].value;
        c = tab[c].next;
      }
      op += len;
      occ -= len;
    } else {
      *op++ = uint8_t(code);
      --occ;
    }
  }
  return occ > 0 ? ERR_LZW_SHORT : 0;
}

// ---------------------------------------------------------------- CCITT

// mkg3states.c's states
enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
       S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state, width;
  uint32_t param;
};

struct Proto {
  const char* bits;  // the code as it is sent, first bit first
  uint32_t param;
};

// ITU-T T.4 tables 2 and 3 (terminating and make-up codes), table 4 (2-D)
const Proto kTermW[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4},
    {"1100", 5}, {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9},
    {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13},
    {"110100", 14}, {"110101", 15}, {"101010", 16}, {"101011", 17},
    {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25},
    {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33},
    {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37},
    {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45},
    {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57},
    {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}, {nullptr, 0}};
const Proto kMakeUpW[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256},
    {"00110110", 320}, {"00110111", 384}, {"01100100", 448},
    {"01100101", 512}, {"01101000", 576}, {"01100111", 640},
    {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408},
    {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}, {nullptr, 0}};
const Proto kTermB[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4},
    {"0011", 5}, {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9},
    {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16},
    {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22},
    {"00000101000", 23}, {"00000010111", 24}, {"00000011000", 25},
    {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37},
    {"000011010110", 38}, {"000011010111", 39}, {"000001101100", 40},
    {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46},
    {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52},
    {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61},
    {"000001100110", 62}, {"000001100111", 63}, {nullptr, 0}};
const Proto kMakeUpB[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192},
    {"000001011011", 256}, {"000000110011", 320}, {"000000110100", 384},
    {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}, {nullptr, 0}};
const Proto kMakeUp[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}, {nullptr, 0}};
const Proto kPass[] = {{"0001", 0}, {nullptr, 0}};
const Proto kHoriz[] = {{"001", 0}, {nullptr, 0}};
const Proto kV0[] = {{"1", 0}, {nullptr, 0}};
const Proto kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3},
                     {nullptr, 0}};
const Proto kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3},
                     {nullptr, 0}};
const Proto kExt[] = {{"0000001", 0}, {nullptr, 0}};
const Proto kEolV[] = {{"0000000", 0}, {nullptr, 0}};
const Proto kEolH[] = {{"00000000000", 0}, {nullptr, 0}};

// mkg3states.c FillTable: every `size`-bit index whose low bits are the
// code, as the decoder reads it (first bit in the lowest place)
void fill_table(std::vector<TabEnt>& t, int size, const Proto* p,
                uint8_t state) {
  for (; p->bits; ++p) {
    const int width = int(std::strlen(p->bits));
    int code = 0;
    for (int i = 0; i < width; ++i)
      if (p->bits[i] == '1') code |= 1 << i;
    for (int c = code; c < (1 << size); c += 1 << width)
      t[size_t(c)] = {state, uint8_t(width), p->param};
  }
}

struct FaxTables {
  std::vector<TabEnt> main, white, black;
  FaxTables() : main(128), white(4096), black(8192) {
    fill_table(main, 7, kPass, S_Pass);
    fill_table(main, 7, kHoriz, S_Horiz);
    fill_table(main, 7, kV0, S_V0);
    fill_table(main, 7, kVR, S_VR);
    fill_table(main, 7, kVL, S_VL);
    fill_table(main, 7, kExt, S_Ext);
    fill_table(main, 7, kEolV, S_EOL);
    fill_table(white, 12, kMakeUpW, S_MakeUpW);
    fill_table(white, 12, kMakeUp, S_MakeUp);
    fill_table(white, 12, kTermW, S_TermW);
    fill_table(white, 12, kEolH, S_EOL);
    fill_table(black, 13, kMakeUpB, S_MakeUpB);
    fill_table(black, 13, kMakeUp, S_MakeUp);
    fill_table(black, 13, kTermB, S_TermB);
    fill_table(black, 13, kEolH, S_EOL);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

uint8_t reverse_bits(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// Bits [x, x + run) of a row set to `colour`, first bit highest.
void set_bits(uint8_t* buf, uint32_t x, uint32_t run, int colour) {
  while (run && (x & 7)) {
    const uint8_t bit = uint8_t(0x80 >> (x & 7));
    buf[x >> 3] = colour ? uint8_t(buf[x >> 3] | bit)
                         : uint8_t(buf[x >> 3] & ~bit);
    ++x;
    --run;
  }
  std::memset(buf + (x >> 3), colour ? 0xFF : 0, run >> 3);
  x += run & ~7u;
  for (run &= 7; run; --run, ++x) {
    const uint8_t bit = uint8_t(0x80 >> (x & 7));
    buf[x >> 3] = colour ? uint8_t(buf[x >> 3] | bit)
                         : uint8_t(buf[x >> 3] & ~bit);
  }
}

// _TIFFFax3fillruns: the row's runs, white (0) then black (1) by turns,
// over its first `lastx` bits; the bits past them keep their value.
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      set_bits(buf, x, run, colour);
      x += runs[colour];
    }
  }
}

// tif_fax3.c's decoders over one strip or tile: Fax3DecodeRLE
// (compression 2), Fax3Decode1D and Fax3Decode2D (3, by T4Options bit 0)
// and Fax4Decode (4), with the macros of tif_fax3.h. A bad code is
// reported by libtiff and decoding goes on; running out of data fails,
// except in Group 4, which keeps the rows decoded so far.
class Fax {
 public:
  Fax(const uint8_t* data, int64_t n, bool msb_first, int64_t rowpixels,
      bool two_d, bool no_eol)
      : start_(data), cp_(data), ep_(data + n), rev_(msb_first),
        no_eol_(no_eol), lastx_(int(rowpixels)) {
    nruns_ = uint32_t(((rowpixels + 1) + 31) / 32 * 32);
    if (two_d) nruns_ *= 2;
    // calloc: pages a row's runs never reach are never touched
    runs_.reset(static_cast<uint32_t*>(
        std::calloc(size_t(nruns_) * 2, sizeof(uint32_t))));
    cur_ = runs_.get();
    ref_ = two_d && cur_ ? cur_ + nruns_ : nullptr;
    if (ref_) {
      ref_[0] = uint32_t(rowpixels);
      ref_[1] = 0;
    }
  }

  bool ok() const { return cur_ != nullptr; }
  int decode_rle(uint8_t* buf, int64_t rows, int64_t rowbytes, bool word,
                 int64_t base);
  int decode_1d(uint8_t* buf, int64_t rows, int64_t rowbytes);
  int decode_2d(uint8_t* buf, int64_t rows, int64_t rowbytes);
  int decode_g4(uint8_t* buf, int64_t rows, int64_t rowbytes);

 private:
  enum Result { kOk, kEof, kOverflow, kNoEol };

  // NeedBits8/NeedBits16: past the end, a partial code is padded with
  // zeros; with no bit left the data has ended
  bool need(int n) {
    while (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) return false;
        avail_ = n;
        return true;
      }
      const uint8_t b = rev_ ? reverse_bits(*cp_++) : *cp_++;
      acc_ |= uint32_t(b) << avail_;
      avail_ += 8;
    }
    return true;
  }
  uint32_t get(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    avail_ -= n;
    acc_ >>= n;
  }
  bool lookup(int width, const std::vector<TabEnt>& t, const TabEnt** e) {
    if (!need(width)) return false;
    *e = &t[get(width)];
    clr((*e)->width);
    return true;
  }
  bool setvalue(uint32_t x) {
    if (pa_ >= thisrun_ + nruns_) return false;
    *pa_++ = uint32_t(run_length_) + x;
    a0_ += int(x);
    run_length_ = 0;
    return true;
  }
  bool cleanup_runs();
  Result sync_eol();
  Result expand_1d();
  Result expand_2d();
  bool check_b1();

  const uint8_t* start_;
  const uint8_t* cp_;
  const uint8_t* ep_;
  bool rev_;

 public:
  // FAXMODE_NOEOL: set once a Group 3 row's EOL is not found; from then
  // on (this strip and the image's later ones) rows are read without
  // looking for EOLs
  bool no_eol_;

 private:
  int lastx_;
  uint32_t acc_ = 0;
  int avail_ = 0;
  int eolcnt_ = 0;
  uint32_t nruns_;
  std::unique_ptr<uint32_t, decltype(&std::free)> runs_{nullptr, &std::free};
  uint32_t* cur_;
  uint32_t* ref_;
  uint32_t* thisrun_ = nullptr;
  uint32_t* pa_ = nullptr;
  uint32_t* pb_ = nullptr;
  int a0_ = 0, b1_ = 0, run_length_ = 0;
};

bool Fax::cleanup_runs() {
  if (run_length_ && !setvalue(0)) return false;
  if (a0_ != lastx_) {
    while (a0_ > lastx_ && pa_ > thisrun_) a0_ -= int(*--pa_);
    if (a0_ < lastx_) {
      if (a0_ < 0) a0_ = 0;
      if ((pa_ - thisrun_) & 1 && !setvalue(0)) return false;
      if (!setvalue(uint32_t(lastx_ - a0_))) return false;
    } else if (a0_ > lastx_) {
      if (!setvalue(uint32_t(lastx_)) || !setvalue(0)) return false;
    }
  }
  return true;
}

// SYNC_EOL as libtiff 4.7 has it: skip to the EOL and past it; where the
// data ends before the EOL's closing bit, the row is read again without
// an EOL from where this strip's decoding began ("Try to decode (read)
// fax Group 3 data without EOL"), and no EOL is looked for any more
Fax::Result Fax::sync_eol() {
  if (no_eol_) return kOk;
  if (eolcnt_ == 0) {
    for (;;) {
      if (!need(11)) return kEof;
      if (get(11) == 0) break;
      clr(1);
    }
  }
  for (;;) {
    if (!need(8)) {
      no_eol_ = true;
      cp_ = start_;
      acc_ = 0;
      avail_ = 0;
      eolcnt_ = 0;
      return kOk;
    }
    if (get(8)) break;
    clr(8);
  }
  while (get(1) == 0) clr(1);
  clr(1);
  eolcnt_ = 0;
  return kOk;
}

// EXPAND1D: alternate white and black runs to the end of the row
Fax::Result Fax::expand_1d() {
  const auto& tabs = fax_tables();
  const TabEnt* e;
  for (;;) {
    for (bool white : {true, false}) {
      for (;;) {
        if (!lookup(white ? 12 : 13, white ? tabs.white : tabs.black, &e))
          goto eof1d;
        const uint8_t term = white ? S_TermW : S_TermB;
        const uint8_t make = white ? S_MakeUpW : S_MakeUpB;
        if (e->state == S_EOL) {
          eolcnt_ = 1;
          goto done1d;
        }
        if (e->state == term) {
          if (!setvalue(e->param)) return kOverflow;
          break;
        }
        if (e->state == make || e->state == S_MakeUp) {
          a0_ += int(e->param);
          run_length_ += int(e->param);
          continue;
        }
        goto done1d;  // unexpected: libtiff reports it and ends the row
      }
      if (a0_ >= lastx_) goto done1d;
    }
    if (*(pa_ - 1) == 0 && *(pa_ - 2) == 0) pa_ -= 2;
  }
eof1d:
  if (!cleanup_runs()) return kOverflow;
  return kEof;
done1d:
  if (!cleanup_runs()) return kOverflow;
  return kOk;
}

bool Fax::check_b1() {
  if (pa_ != thisrun_) {
    while (b1_ <= a0_ && b1_ < lastx_) {
      if (pb_ + 1 >= ref_ + nruns_) return false;
      b1_ += int(pb_[0] + pb_[1]);
      pb_ += 2;
    }
  }
  return true;
}

// EXPAND2D: the row coded against the reference row
Fax::Result Fax::expand_2d() {
  const auto& tabs = fax_tables();
  const TabEnt* e;
  while (a0_ < lastx_) {
    if (pa_ >= thisrun_ + nruns_) return kOverflow;
    if (!lookup(7, tabs.main, &e)) goto eof2d;
    switch (e->state) {
      case S_Pass:
        if (!check_b1()) return kOverflow;
        if (pb_ + 1 >= ref_ + nruns_) return kOverflow;
        b1_ += int(*pb_++);
        run_length_ += b1_ - a0_;
        a0_ = b1_;
        b1_ += int(*pb_++);
        break;
      case S_Horiz: {
        const bool black_first = (pa_ - thisrun_) & 1;
        for (int k = 0; k < 2; ++k) {
          const bool white = black_first ? k == 1 : k == 0;
          for (;;) {
            if (!lookup(white ? 12 : 13, white ? tabs.white : tabs.black,
                        &e))
              goto eof2d;
            if (e->state == (white ? S_TermW : S_TermB)) {
              if (!setvalue(e->param)) return kOverflow;
              break;
            }
            if (e->state == (white ? S_MakeUpW : S_MakeUpB) ||
                e->state == S_MakeUp) {
              a0_ += int(e->param);
              run_length_ += int(e->param);
              continue;
            }
            goto eol2d;  // unexpected
          }
        }
        if (!check_b1()) return kOverflow;
        break;
      }
      case S_V0:
        if (!check_b1()) return kOverflow;
        if (!setvalue(uint32_t(b1_ - a0_))) return kOverflow;
        if (pb_ >= ref_ + nruns_) return kOverflow;
        b1_ += int(*pb_++);
        break;
      case S_VR:
        if (!check_b1()) return kOverflow;
        if (!setvalue(uint32_t(b1_ - a0_ + int(e->param)))) return kOverflow;
        if (pb_ >= ref_ + nruns_) return kOverflow;
        b1_ += int(*pb_++);
        break;
      case S_VL:
        if (!check_b1()) return kOverflow;
        if (b1_ < a0_ + int(e->param)) goto eol2d;  // unexpected
        if (!setvalue(uint32_t(b1_ - a0_ - int(e->param)))) return kOverflow;
        b1_ -= int(*--pb_);
        break;
      case S_Ext:
        *pa_++ = uint32_t(lastx_ - a0_);
        goto eol2d;  // uncompressed mode: libtiff does not read it
      case S_EOL:
        *pa_++ = uint32_t(lastx_ - a0_);
        if (!need(4)) goto eof2d;
        clr(4);
        eolcnt_ = 1;
        goto eol2d;
      default:
        goto eol2d;  // unexpected
    }
  }
  if (run_length_) {
    if (run_length_ + a0_ < lastx_) {  // a final V0 is expected
      if (!need(1)) goto eof2d;
      if (!get(1)) goto eol2d;  // unexpected
      clr(1);
    }
    if (!setvalue(0)) return kOverflow;
  }
eol2d:
  if (!cleanup_runs()) return kOverflow;
  return kOk;
eof2d:
  if (!cleanup_runs()) return kOverflow;
  return kEof;
}

// Fax3DecodeRLE: each row ends on a byte (FAXMODE_BYTEALIGN, compression
// 2) or a 16-bit word (FAXMODE_WORDALIGN, 32771): the bits left in the
// word are dropped and, where none are left, a byte at an odd address is
// stepped over. `base` is the parity of the strip's first byte in libtiff's
// buffer, which is the file Pillow maps: the strip's offset.
int Fax::decode_rle(uint8_t* buf, int64_t rows, int64_t rowbytes, bool word,
                    int64_t base) {
  thisrun_ = cur_;
  for (int64_t r = 0; r < rows; ++r) {
    a0_ = 0;
    run_length_ = 0;
    pa_ = thisrun_;
    const Result res = expand_1d();
    if (res == kOverflow) return ERR_FAX;
    fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
    if (res == kEof) return ERR_FAX;
    if (word) {
      clr(avail_ - (avail_ & ~15));
      if (avail_ == 0 && ((cp_ - start_) + base) & 1) ++cp_;
    } else {
      clr(avail_ - (avail_ & ~7));
    }
    buf += rowbytes;
  }
  return 0;
}

int Fax::decode_1d(uint8_t* buf, int64_t rows, int64_t rowbytes) {
  thisrun_ = cur_;
  for (int64_t r = 0; r < rows; ++r) {
    a0_ = 0;
    run_length_ = 0;
    pa_ = thisrun_;
    Result res = sync_eol();
    if (res == kOk) {
      res = expand_1d();
    } else if (!cleanup_runs()) {
      return ERR_FAX;
    }
    if (res == kOverflow) return ERR_FAX;
    fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
    if (res == kEof) return ERR_FAX;
    buf += rowbytes;
  }
  return 0;
}

int Fax::decode_2d(uint8_t* buf, int64_t rows, int64_t rowbytes) {
  for (int64_t r = 0; r < rows; ++r) {
    a0_ = 0;
    run_length_ = 0;
    pa_ = thisrun_ = cur_;
    Result res = sync_eol();
    if (res == kOk && !need(1)) res = kEof;
    if (res != kOk) {
      if (!cleanup_runs()) return ERR_FAX;
      fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
      return ERR_FAX;
    }
    const bool one_d = get(1);
    clr(1);
    pb_ = ref_;
    b1_ = int(*pb_++);
    res = one_d ? expand_1d() : expand_2d();
    if (res == kOverflow) return ERR_FAX;
    fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
    if (res == kEof) return ERR_FAX;
    if (pa_ < thisrun_ + nruns_ && !setvalue(0)) return ERR_FAX;
    std::swap(cur_, ref_);
    buf += rowbytes;
  }
  return 0;
}

int Fax::decode_g4(uint8_t* buf, int64_t rows, int64_t rowbytes) {
  for (int64_t r = 0; r < rows; ++r) {
    a0_ = 0;
    run_length_ = 0;
    pa_ = thisrun_ = cur_;
    pb_ = ref_;
    b1_ = int(*pb_++);
    const Result res = expand_2d();
    if (res == kOverflow) return ERR_FAX;
    if (res == kEof || eolcnt_) {
      // EOFB, or the data ended: the row as decoded so far; the rows
      // after it keep what the buffer held ("don't error on
      // badly-terminated strips"), unless no row was decoded
      fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
      return r > 0 ? 0 : ERR_FAX;
    }
    fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
    if (!setvalue(0)) return ERR_FAX;
    std::swap(cur_, ref_);
    buf += rowbytes;
  }
  return 0;
}

int fax_strip(const uint8_t* data, int64_t n, int compression,
              int64_t t4options, int lsb_first, int64_t rowpixels,
              int64_t rows, int64_t rowbytes, uint8_t* out, int32_t* no_eol,
              int64_t base) {
  const bool two_d = compression == 4 || (compression == 3 && (t4options & 1));
  // Fax3SetupState: run arrays of roundup(rowpixels + 1, 32) runs, twice
  // that with a reference line, twice again in all, a count that must fit
  // a uint32_t; a row of more than INT_MAX pixels Pillow never asks for
  if (rowpixels <= 0 || rowpixels > INT32_MAX) return ERR_FAX;
  uint64_t nruns = (uint64_t(rowpixels) + 1 + 31) / 32 * 32;
  if (two_d) nruns *= 2;
  if (nruns * 2 > UINT32_MAX) return ERR_FAX;
  Fax fax(data, n, !lsb_first, rowpixels, two_d, *no_eol != 0);
  if (!fax.ok()) return ERR_FAX;  // _TIFFCheckMalloc's failure
  int status;
  if (compression == 2 || compression == 32771)
    status = fax.decode_rle(out, rows, rowbytes, compression == 32771, base);
  else if (compression == 4)
    status = fax.decode_g4(out, rows, rowbytes);
  else if (two_d)
    status = fax.decode_2d(out, rows, rowbytes);
  else
    status = fax.decode_1d(out, rows, rowbytes);
  *no_eol = fax.no_eol_;
  return status;
}

}  // namespace

extern "C" {

// tif_packbits.c PackBitsDecode: runs and literals until `occ` bytes are
// out; a run or literal that overflows is cut; the data ending first
// fails the strip.
int ecgmm_tiff_packbits(const uint8_t* bp, int64_t cc, uint8_t* op,
                        int64_t occ) {
  while (cc > 0 && occ > 0) {
    int64_t n = int8_t(*bp++);
    --cc;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < n) n = occ;
      if (cc == 0) break;
      occ -= n;
      const uint8_t b = *bp++;
      --cc;
      std::memset(op, b, size_t(n));
      op += n;
    } else {
      if (occ < n + 1) n = occ - 1;
      if (cc < n + 1) break;
      ++n;
      std::memcpy(op, bp, size_t(n));
      op += n;
      occ -= n;
      bp += n;
      cc -= n;
    }
  }
  if (occ > 0) {
    std::memset(op, 0, size_t(occ));
    return ERR_PACKBITS_SHORT;
  }
  return 0;
}

// tif_lzw.c: LZWPreDecode's choice (old-style codes begin 0x00 then a
// byte with its low bit set), then the decoder
int ecgmm_tiff_lzw(const uint8_t* bp, int64_t n, uint8_t* op, int64_t occ) {
  if (n >= 2 && bp[0] == 0 && (bp[1] & 1)) return lzw_compat(bp, n, op, occ);
  return lzw_new(bp, n, op, occ);
}

// One CCITT strip or tile of `rows` rows of `rowpixels` bits, each row
// `rowbytes` apart in `out`. compression 2 (modified Huffman RLE), 3 (T.4,
// 2-D where T4Options bit 0 is set) or 4 (T.6); `lsb_first`: FillOrder 2;
// `no_eol` (in and out): Group 3's FAXMODE_NOEOL, which outlives a strip.
int ecgmm_tiff_fax(const uint8_t* data, int64_t n, int compression,
                   int64_t t4options, int lsb_first, int64_t rowpixels,
                   int64_t rows, int64_t rowbytes, uint8_t* out,
                   int32_t* no_eol) {
  return fax_strip(data, n, compression, t4options, lsb_first, rowpixels, rows,
                   rowbytes, out, no_eol, 0);
}

// Compression 32771, modified Huffman RLE with each row word-aligned;
// `base`: the parity of the strip's offset in the file.
int ecgmm_tiff_fax_rlew(const uint8_t* data, int64_t n, int lsb_first,
                        int64_t rowpixels, int64_t rows, int64_t rowbytes,
                        uint8_t* out, int64_t base) {
  int32_t no_eol = 0;
  return fax_strip(data, n, 32771, 0, lsb_first, rowpixels, rows, rowbytes,
                   out, &no_eol, base);
}

// tif_thunder.c ThunderDecodeRow: each row of `width` 4-bit pixels decoded
// from where the last one ended (the last pixel reset to 0): runs of the
// last pixel, 2- and 3-bit deltas, raw pixels; a run past the row's end
// writes nothing. A row left short or overrun fails the strip, its bytes
// past the last written zeroed.
int ecgmm_tiff_thunder(const uint8_t* bp, int64_t cc, int64_t width,
                       int64_t rows, int64_t rowbytes, uint8_t* out) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* op0 = out + r * rowbytes;
    uint8_t* op = op0;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < width) {
        if (npixels++ & 1)
          *op++ |= uint8_t(lastpixel);
        else
          op[0] = uint8_t(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < width) {
      int n = *bp++;
      --cc;
      int delta;
      switch (n & 0xc0) {
        case 0x00:
          if (npixels & 1) {
            op[0] |= uint8_t(lastpixel);
            lastpixel = *op++;
            ++npixels;
            --n;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += n;
          if (npixels <= width)
            for (; n > 0; n -= 2) *op++ = uint8_t(lastpixel);
          if (n == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        case 0x40:
          if ((delta = (n >> 4) & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          if ((delta = (n >> 2) & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          if ((delta = n & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          break;
        case 0x80:
          if ((delta = (n >> 3) & 7) != 4)
            setpixel(unsigned(int(lastpixel) + three[delta]));
          if ((delta = n & 7) != 4)
            setpixel(unsigned(int(lastpixel) + three[delta]));
          break;
        default:
          setpixel(unsigned(n));
          break;
      }
    }
    if (npixels != width) {
      uint8_t* end = op0 + (width + 1) / 2;
      if (end > op) std::memset(op, 0, size_t(end - op));
      return ERR_FAX;
    }
  }
  return 0;
}

}  // extern "C"

extern "C" {

// TIFFYCbCrtoRGB over contiguous YCbCr sampling blocks (hs x vs luma
// samples, then Cb and Cr; `across` blocks a block row, at least
// ceil(width / hs)) into `rows` x `width` RGB bytes. The tables are
// tif_color.c's (Y, Cr->R, Cb->B, Cr->G, Cb->G, 256 entries each, the
// last two before their shift by 16).
int ecgmm_ycbcr_blocks(const uint8_t* blocks, int64_t rows, int64_t width,
                       int64_t across, int hs, int vs, const int64_t* y_tab,
                       const int64_t* cr_r, const int64_t* cb_b,
                       const int64_t* cr_g, const int64_t* cb_g,
                       uint8_t* out) {
  const int64_t per = int64_t(hs) * vs + 2;
  auto clamp = [](int64_t v) -> uint8_t {
    return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
  };
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* brow = blocks + (y / vs) * across * per;
    const int sy = int(y % vs);
    uint8_t* o = out + y * width * 3;
    for (int64_t x = 0; x < width; ++x) {
      const uint8_t* b = brow + (x / hs) * per;
      const int64_t yv = y_tab[b[sy * hs + x % hs]];
      const int cb = b[hs * vs], cr = b[hs * vs + 1];
      o[3 * x] = clamp(yv + cr_r[cr]);
      o[3 * x + 1] = clamp(yv + ((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp(yv + cb_b[cb]);
    }
  }
  return 0;
}

}  // extern "C"
