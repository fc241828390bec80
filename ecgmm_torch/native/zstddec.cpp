// Zstandard frames (RFC 8878) as libtiff's ZSTDDecode reads a strip with
// libzstd 1.5's ZSTD_decompressStream: raw, RLE and compressed blocks;
// Huffman-coded literals (one or four streams, treeless repeats); FSE-coded
// sequences in predefined, RLE, compressed and repeat modes with the
// repeat offsets; the XXH64 content checksum; skippable frames. The
// refusals follow libzstd's: a reserved bit or block type, a window above
// libzstd's default limit (2^27 + 1, when it streams), a block above
// min(window, 128 KiB), an FSE or Huffman header it rejects, a bitstream
// that does not end where its data ends, an offset before the frame's
// first byte, a content size or checksum that does not match.
//
// libtiff stops as soon as the strip buffer is full: libzstd decodes a
// whole block into its own buffer before it copies it out, so the block
// that fills the strip is decoded (and checked) whole, and where the strip
// fills exactly at a block's end the next block, or the checksum, is read
// too if its bytes are there. A frame whose content size is known, fits
// the strip and lies whole in the data libzstd decodes in one pass instead.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int OK = 0;
constexpr int ERR_CORRUPT = -50;       // corruption_detected and kin
constexpr int ERR_SHORT = -51;         // the data ends first (libtiff: not
                                       // enough data)
constexpr int ERR_CHECKSUM = -52;      // checksum_wrong
constexpr int ERR_WINDOW = -53;        // frameParameter_windowTooLarge
constexpr int ERR_PREFIX = -54;        // prefix_unknown
constexpr int ERR_UNSUPPORTED = -55;   // frameParameter_unsupported
constexpr int ERR_DICTIONARY = -56;    // dictionary_wrong / corrupted

constexpr uint64_t kBlockMax = 128 * 1024;
constexpr uint64_t kWindowLimit = (uint64_t(1) << 27) + 1;

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd32(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t(rd32(p + 4)) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = uint64_t(0) - P1;
    while (end - p >= 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -------------------------------------------------- backward bitstream

// A stream read from its end: the last byte's highest set bit marks the
// end; bits are taken from there toward the first byte. Past the first
// byte the reads give zeros and the stream has overflowed.
struct BackBits {
  const uint8_t* src = nullptr;
  int64_t size = 0;
  int64_t below = 0;     // bytes before src that reads may reach
  bool wrap = false;     // libzstd's fast four-stream decoding
  int64_t total = 0;     // the bits before the marker
  int64_t consumed = 0;

  bool init(const uint8_t* p, int64_t n) {
    if (n < 1) return false;
    const uint8_t last = p[n - 1];
    if (last == 0) return false;
    src = p;
    size = n;
    total = 8 * n - (8 - highbit(last));
    consumed = 0;
    return true;
  }
  // HUF_initFastDStream: a last byte of 0 is no error (no marker: every
  // bit is data), and reads past the stream's first byte go on into the
  // `back` bytes before it
  void init_fast(const uint8_t* p, int64_t n, int64_t back) {
    src = p;
    size = n;
    below = back;
    wrap = true;
    const uint8_t last = p[n - 1];
    total = last ? 8 * n - (8 - highbit(last)) : 8 * n;
    consumed = 0;
  }
  // bits [lo, lo + n) of the stream read as a little-endian integer (bits
  // below the readable bytes read as 0; in the fast loop's stream, a read
  // wholly below them reads BIT_lookBitsFast's wrapped shift of the first
  // 8 bytes, as libzstd's overflowed bit container does)
  uint64_t bits(int64_t lo, int n) const {
    if (n == 0) return 0;
    lo += 8 * below;
    if (wrap && lo + n <= 0) lo = 64 - ((64 - lo - n) & 63) - n;
    const uint8_t* base = src - below;
    const int64_t bytes = size + below;
    int shift = 0;
    if (lo < 0) {
      shift = int(-lo);
      if (shift >= n) return 0;
      n -= shift;
      lo = 0;
    }
    const int64_t b0 = lo >> 3;
    const int off = int(lo & 7);
    uint64_t w = 0;
    for (int i = 0; i < 8 && b0 + i < bytes; ++i)
      w |= uint64_t(base[b0 + i]) << (8 * i);
    uint64_t v = w >> off;
    if (off + n > 64 && b0 + 8 < bytes)
      v |= uint64_t(base[b0 + 8]) << (64 - off);
    v &= (n >= 64) ? ~uint64_t(0) : ((uint64_t(1) << n) - 1);
    return v << shift;
  }
  uint64_t peek(int n) const { return bits(total - consumed - n, n); }
  uint64_t read(int n) {
    const uint64_t v = peek(n);
    consumed += n;
    return v;
  }
  bool overflow() const { return consumed > total; }
  bool finished() const { return consumed == total; }
};

// ------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t next;  // newState base
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// FSE_readNCount, as libzstd reads it (its clamped reads near the end
// included): the normalised counts, the table log and the header's size.
int64_t read_ncount(const uint8_t* src, int64_t n, int max_log,
                    int max_symbol, std::vector<int16_t>& norm, int* log) {
  uint8_t pad[8] = {0};
  if (n < 8) {
    std::memcpy(pad, src, size_t(n));
    const int64_t got = read_ncount(pad, 8, max_log, max_symbol, norm, log);
    if (got < 0) return got;
    if (got > n) return ERR_CORRUPT;
    return got;
  }
  (void)max_log;
  const uint8_t* istart = src;
  const uint8_t* iend = src + n;
  const uint8_t* ip = src;
  norm.assign(size_t(max_symbol) + 1, 0);
  const int max_sv1 = max_symbol + 1;
  int previous0 = 0;
  int charnum = 0;
  uint32_t bitstream = rd32(ip);
  int nbbits = int(bitstream & 0xF) + 5;
  if (nbbits > 15) return ERR_CORRUPT;
  bitstream >>= 4;
  int bitcount = 4;
  *log = nbbits;
  int remaining = (1 << nbbits) + 1;
  int threshold = 1 << nbbits;
  nbbits++;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bitcount >> 3) <= iend - 4) {
      ip += bitcount >> 3;
      bitcount &= 7;
    } else {
      bitcount -= int(8 * (iend - 4 - ip));
      bitcount &= 31;
      ip = iend - 4;
    }
    bitstream = rd32(ip) >> bitcount;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bitstream | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bitcount -= int(8 * (iend - 7 - ip));
          bitcount &= 31;
          ip = iend - 4;
        }
        bitstream = rd32(ip) >> bitcount;
        repeats = __builtin_ctz(~bitstream | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bitstream >>= 2 * repeats;
      bitcount += 2 * repeats;
      charnum += int(bitstream & 3);
      bitcount += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if (int(bitstream & uint32_t(threshold - 1)) < max) {
        count = int(bitstream & uint32_t(threshold - 1));
        bitcount += nbbits - 1;
      } else {
        count = int(bitstream & uint32_t(2 * threshold - 1));
        if (count >= threshold) count -= max;
        bitcount += nbbits;
      }
      count--;
      if (count >= 0)
        remaining -= count;
      else
        remaining += count;
      norm[size_t(charnum++)] = int16_t(count);
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nbbits = highbit(uint32_t(remaining)) + 1;
        threshold = 1 << (nbbits - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1) return ERR_CORRUPT;
  if (charnum > max_sv1) return ERR_CORRUPT;
  if (bitcount > 32) return ERR_CORRUPT;
  norm.resize(size_t(charnum));
  ip += (bitcount + 7) >> 3;
  return ip - istart;
}

// FSE_buildDTable: the spread symbols, each state's bits and next base
bool build_fse(const std::vector<int16_t>& norm, int log, FseTable* out) {
  const int size = 1 << log;
  std::vector<FseEntry>& t = out->t;
  t.assign(size_t(size), FseEntry{0, 0, 0});
  out->log = log;
  std::vector<uint32_t> next(norm.size(), 0);
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      t[size_t(high--)].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  const int mask = size - 1;
  const int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t[size_t(pos)].symbol = uint16_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    const uint16_t s = t[size_t(u)].symbol;
    const uint32_t ns = next[s]++;
    const int nb = log - highbit(ns);
    t[size_t(u)].nbits = uint8_t(nb);
    t[size_t(u)].next = uint16_t((ns << nb) - uint32_t(size));
  }
  return true;
}

// ------------------------------------------------------------ Huffman

struct Huffman {
  int log = 0;
  std::vector<uint8_t> sym;
  std::vector<uint8_t> nbits;
};

// HUF_readStats and HUF_readDTableX1: the weights (4-bit direct or
// FSE-coded), the last one implied; the table read by the top `log` bits.
int64_t read_huffman(const uint8_t* src, int64_t n, Huffman* h) {
  if (n < 1) return ERR_CORRUPT;
  uint8_t w[256] = {0};
  int64_t isize = src[0];
  int osize;
  if (isize >= 128) {
    osize = int(isize - 127);
    isize = (osize + 1) / 2;
    if (isize + 1 > n) return ERR_CORRUPT;
    if (osize >= 256) return ERR_CORRUPT;
    for (int k = 0; k < osize; k += 2) {
      w[k] = src[1 + k / 2] >> 4;
      w[k + 1] = src[1 + k / 2] & 15;
    }
  } else {
    if (isize + 1 > n) return ERR_CORRUPT;
    // FSE_decompress_wksp: at most 255 weights, table log at most 6
    const uint8_t* p = src + 1;
    std::vector<int16_t> norm;
    int log = 0;
    const int64_t hs = read_ncount(p, isize, 6, 255, norm, &log);
    if (hs < 0) return hs;
    if (log > 6) return ERR_CORRUPT;
    FseTable t;
    if (!build_fse(norm, log, &t)) return ERR_CORRUPT;
    BackBits b;
    if (!b.init(p + hs, isize - hs)) return ERR_CORRUPT;
    uint32_t s1 = uint32_t(b.read(log)), s2 = uint32_t(b.read(log));
    osize = 0;
    auto step = [&](uint32_t* st) {
      const FseEntry& e = t.t[*st];
      w[osize++] = uint8_t(e.symbol);
      *st = e.next + uint32_t(b.read(e.nbits));
    };
    for (;;) {
      if (osize > 255 - 2) return ERR_CORRUPT;
      step(&s1);
      if (b.overflow()) {
        step(&s2);
        break;
      }
      if (osize > 255 - 2) return ERR_CORRUPT;
      step(&s2);
      if (b.overflow()) {
        step(&s1);
        break;
      }
    }
  }
  uint32_t ranks[13] = {0};
  uint32_t total = 0;
  for (int k = 0; k < osize; ++k) {
    if (w[k] > 12) return ERR_CORRUPT;
    ranks[w[k]]++;
    total += (1u << w[k]) >> 1;
  }
  if (total == 0) return ERR_CORRUPT;
  const int log = highbit(total) + 1;
  if (log > 12) return ERR_CORRUPT;
  const uint32_t rest = (1u << log) - total;
  if ((1u << highbit(rest)) != rest) return ERR_CORRUPT;
  w[osize] = uint8_t(highbit(rest) + 1);
  ranks[w[osize]]++;
  if (ranks[1] < 2 || (ranks[1] & 1)) return ERR_CORRUPT;
  const int nsym = osize + 1;
  uint32_t start[14] = {0};
  uint32_t next = 0;
  for (int k = 1; k <= log; ++k) {
    start[k] = next;
    next += ranks[k] << (k - 1);
  }
  h->log = log;
  h->sym.assign(size_t(1) << log, 0);
  h->nbits.assign(size_t(1) << log, 0);
  for (int s = 0; s < nsym; ++s) {
    const int wt = w[s];
    if (!wt) continue;
    const uint32_t len = (1u << wt) >> 1;
    for (uint32_t u = start[wt]; u < start[wt] + len; ++u) {
      h->sym[u] = uint8_t(s);
      h->nbits[u] = uint8_t(log + 1 - wt);
    }
    start[wt] += len;
  }
  return isize + 1;
}

// `count` symbols of one Huffman stream. `back` < 0: the checked decoder
// (the stream must end exactly where its data does); else libzstd's fast
// four-stream loop, which checks neither and may read `back` bytes before
// the stream
bool huff_stream(const Huffman& h, const uint8_t* src, int64_t n, uint8_t* out,
                 int64_t count, int64_t back = -1,
                 std::vector<uint8_t>* lengths = nullptr) {
  BackBits b;
  if (back >= 0)
    b.init_fast(src, n, back);
  else if (!b.init(src, n))
    return false;
  if (lengths) lengths->resize(size_t(count));
  for (int64_t i = 0; i < count; ++i) {
    const uint32_t v = uint32_t(b.peek(h.log));
    out[i] = h.sym[v];
    b.consumed += h.nbits[v];
    if (lengths) (*lengths)[size_t(i)] = h.nbits[v];
  }
  return back >= 0 || b.finished();
}

// HUF_decompress4X1_usingDTable_internal_fast's loop, followed for where
// it leaves each stream's input pointer: rounds of 5 symbols a stream while
// the fourth stream's output and the first stream's input (7 bytes a
// round above the section's start) allow, stopping where a stream's
// pointer falls below the one before; then HUF_initRemainingDStream fails
// where a pointer lies more than 8 bytes before its stream. `start` and
// `len` are the streams' offsets in the section and lengths, `first` the
// bits each first window begins with consumed.
bool fast_loop_ok(const std::vector<uint8_t>* lengths, const int64_t* start,
                  const int64_t* len, const int* first, int64_t size,
                  int64_t seg) {
  int64_t ip[4], bc[4], done = 0;
  for (int k = 0; k < 4; ++k) {
    ip[k] = start[k] + len[k] - 8;
    bc[k] = first[k];
  }
  for (;;) {
    const int64_t oiters = (size - (3 * seg + done)) / 5;
    const int64_t iiters = ip[0] / 7;
    const int64_t iters = oiters < iiters ? oiters : iiters;
    if (iters <= 0) break;
    bool crossed = false;
    for (int k = 1; k < 4; ++k) crossed = crossed || ip[k] < ip[k - 1];
    if (crossed) break;
    for (int64_t it = 0; it < iters; ++it, done += 5) {
      for (int k = 0; k < 4; ++k) {
        for (int64_t j = done; j < done + 5; ++j)
          bc[k] += lengths[k][size_t(j)];
        ip[k] -= bc[k] >> 3;
        bc[k] &= 7;
      }
    }
  }
  for (int k = 0; k < 4; ++k)
    if (ip[k] < start[k] - 8) return false;
  return true;
}

// -------------------------------------------------------- sequences

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,  4,  4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct SeqTable {
  FseTable fse;
  bool valid = false;
};

// ZSTD_buildSeqTable for one of LL (0), OF (1), ML (2)
int64_t seq_table(int kind, int mode, const uint8_t* src, int64_t n,
                  SeqTable* st) {
  static const int kMax[3] = {35, 31, 52};
  static const int kMaxLog[3] = {9, 8, 9};
  std::vector<int16_t> norm;
  int log = 0;
  int64_t used = 0;
  if (mode == 0) {
    const int16_t* d = kind == 0 ? kLLNorm : kind == 1 ? kOFNorm : kMLNorm;
    const int cnt = kind == 0 ? 36 : kind == 1 ? 29 : 53;
    norm.assign(d, d + cnt);
    log = kind == 1 ? 5 : 6;
  } else if (mode == 1) {
    if (n < 1) return ERR_CORRUPT;
    if (src[0] > kMax[kind]) return ERR_CORRUPT;
    st->fse.log = 0;
    st->fse.t.assign(1, FseEntry{src[0], 0, 0});
    st->valid = true;
    return 1;
  } else if (mode == 2) {
    used = read_ncount(src, n, kMaxLog[kind], kMax[kind], norm, &log);
    if (used < 0) return ERR_CORRUPT;
    if (log > kMaxLog[kind]) return ERR_CORRUPT;
  } else {
    if (!st->valid) return ERR_CORRUPT;
    return 0;
  }
  if (!build_fse(norm, log, &st->fse)) return ERR_CORRUPT;
  st->valid = true;
  return used;
}

// ------------------------------------------------------------- frame

struct Frame {
  uint64_t window = 0;
  uint64_t block_max = 0;
  int64_t content = -1;  // -1: unknown
  bool checksum = false;
  int header = 0;
};

struct Decoder {
  std::vector<uint8_t> hist;  // the frame's output so far
  Huffman huf;
  bool huf_valid = false;
  SeqTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  uint64_t block_max = kBlockMax;

  int literals(const uint8_t* src, int64_t n, std::vector<uint8_t>* lit,
               int64_t* used) {
    if (n < 2) return ERR_CORRUPT;
    const int type = src[0] & 3;
    const int sf = (src[0] >> 2) & 3;
    if (type < 2) {
      int64_t size, hs;
      if (sf == 0 || sf == 2) {
        size = src[0] >> 3;
        hs = 1;
      } else if (sf == 1) {
        size = (src[0] >> 4) + (int64_t(src[1]) << 4);
        hs = 2;
      } else {
        if (n < 3) return ERR_CORRUPT;
        size = (src[0] >> 4) + (int64_t(src[1]) << 4) +
               (int64_t(src[2]) << 12);
        hs = 3;
      }
      if (uint64_t(size) > block_max) return ERR_CORRUPT;
      if (type == 0) {
        if (hs + size > n) return ERR_CORRUPT;
        lit->assign(src + hs, src + hs + size);
        *used = hs + size;
      } else {
        if (hs + 1 > n) return ERR_CORRUPT;
        lit->assign(size_t(size), src[hs]);
        *used = hs + 1;
      }
      return OK;
    }
    if (type == 3 && !huf_valid) return ERR_DICTIONARY;
    if (n < 5) return ERR_CORRUPT;
    const uint32_t lhc = rd32(src);
    int64_t size, csize, hs;
    bool single = false;
    if (sf == 0 || sf == 1) {
      single = sf == 0;
      hs = 3;
      size = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (sf == 2) {
      hs = 4;
      size = (lhc >> 4) & 0x3FFF;
      csize = lhc >> 18;
    } else {
      hs = 5;
      size = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) + (int64_t(src[4]) << 10);
    }
    if (uint64_t(size) > block_max) return ERR_CORRUPT;
    if (!single && size < 6) return ERR_CORRUPT;
    if (csize + hs > n) return ERR_CORRUPT;
    const uint8_t* p = src + hs;
    int64_t rest = csize;
    if (type == 2) {
      Huffman h;
      const int64_t ts = read_huffman(p, rest, &h);
      if (ts < 0) return ERR_CORRUPT;
      if (ts >= rest) return ERR_CORRUPT;
      huf = h;
      p += ts;
      rest -= ts;
    }
    lit->assign(size_t(size), 0);
    if (single) {
      if (!huff_stream(huf, p, rest, lit->data(), size)) return ERR_CORRUPT;
    } else {
      if (rest < 10) return ERR_CORRUPT;
      const int64_t l1 = rd16(p), l2 = rd16(p + 2), l3 = rd16(p + 4);
      const int64_t l4 = rest - (l1 + l2 + l3 + 6);
      if (l4 < 0) return ERR_CORRUPT;
      const int64_t seg = (size + 3) / 4;
      if (3 * seg > size) return ERR_CORRUPT;
      const uint8_t* q = p + 6;
      const int64_t lens[4] = {l1, l2, l3, l4};
      // HUF_DecompressFastArgs_init: the fast loop (on 64-bit little-endian
      // machines) where each stream holds 8 bytes, the table log is at most
      // 11 and the fourth stream's output is not empty
      const bool fast = huf.log <= 11 && l1 >= 8 && l2 >= 8 && l3 >= 8 &&
                        l4 >= 8 && 3 * seg < size;
      bool ok = true;
      std::vector<uint8_t> lengths[4];
      int64_t starts[4];
      int first[4];
      for (int k = 0; k < 4; ++k) {
        const int64_t cnt = k < 3 ? seg : size - 3 * seg;
        starts[k] = q - p;
        first[k] = !fast ? 0 : q[lens[k] - 1] ? 8 - highbit(q[lens[k] - 1])
                                             : 0;
        if (!huff_stream(huf, q, lens[k], lit->data() + k * seg, cnt,
                         fast ? q - p : -1, fast ? &lengths[k] : nullptr))
          ok = false;
        q += lens[k];
      }
      if (fast && !fast_loop_ok(lengths, starts, lens, first, size, seg))
        ok = false;
      if (!ok) return ERR_CORRUPT;
    }
    huf_valid = true;
    *used = hs + csize;
    return OK;
  }

  int sequences(const uint8_t* src, int64_t n, const std::vector<uint8_t>& lit,
                std::vector<uint8_t>* out) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    if (n < 1) return ERR_CORRUPT;
    int64_t nbseq = *ip++;
    if (nbseq > 0x7F) {
      if (nbseq == 0xFF) {
        if (ip + 2 > iend) return ERR_CORRUPT;
        nbseq = rd16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) return ERR_CORRUPT;
        nbseq = ((nbseq - 0x80) << 8) + *ip++;
      }
    }
    const size_t start = hist.size();
    if (nbseq == 0) {
      if (ip != iend) return ERR_CORRUPT;
      hist.insert(hist.end(), lit.begin(), lit.end());
      (void)out;
      return OK;
    }
    if (ip + 1 > iend) return ERR_CORRUPT;
    const uint8_t modes = *ip++;
    if (modes & 3) return ERR_CORRUPT;
    SeqTable* tabs[3] = {&ll, &of, &ml};
    const int m[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
    for (int k = 0; k < 3; ++k) {
      const int64_t used = seq_table(k, m[k], ip, iend - ip, tabs[k]);
      if (used < 0) return ERR_CORRUPT;
      ip += used;
    }
    BackBits b;
    if (!b.init(ip, iend - ip)) return ERR_CORRUPT;
    uint32_t sll = uint32_t(b.read(ll.fse.log));
    uint32_t sof = uint32_t(b.read(of.fse.log));
    uint32_t sml = uint32_t(b.read(ml.fse.log));
    size_t litpos = 0;
    for (int64_t i = 0; i < nbseq; ++i) {
      const FseEntry& ell = ll.fse.t[sll];
      const FseEntry& eof = of.fse.t[sof];
      const FseEntry& eml = ml.fse.t[sml];
      const int ofcode = eof.symbol;
      const int llcode = ell.symbol;
      const int mlcode = eml.symbol;
      uint64_t offset;
      const bool ll0 = kLLBase[llcode] == 0;
      if (ofcode > 1) {
        offset = (uint64_t(1) << ofcode) - 3 + b.read(ofcode);
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else if (ofcode == 0) {
        offset = rep[ll0 ? 1 : 0];
        rep[1] = rep[ll0 ? 0 : 1];
        rep[0] = offset;
      } else {
        const uint64_t idx = 1 + (ll0 ? 1 : 0) + b.read(1);
        uint64_t temp = idx == 3 ? rep[0] - 1 : rep[idx];
        temp -= !temp;
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset = temp;
      }
      const uint64_t mlen = kMLBase[mlcode] + b.read(kMLBits[mlcode]);
      const uint64_t llen = kLLBase[llcode] + b.read(kLLBits[llcode]);
      if (i + 1 < nbseq) {
        sll = ell.next + uint32_t(b.read(ell.nbits));
        sml = eml.next + uint32_t(b.read(eml.nbits));
        sof = eof.next + uint32_t(b.read(eof.nbits));
      }
      if (llen > lit.size() - litpos) return ERR_CORRUPT;
      if (hist.size() - start + llen + mlen > block_max) return ERR_CORRUPT;
      hist.insert(hist.end(), lit.begin() + int64_t(litpos),
                  lit.begin() + int64_t(litpos + llen));
      litpos += llen;
      if (offset > hist.size()) return ERR_CORRUPT;
      size_t from = hist.size() - size_t(offset);
      for (uint64_t k = 0; k < mlen; ++k) hist.push_back(hist[from++]);
    }
    if (!b.finished()) return ERR_CORRUPT;
    if (hist.size() - start + (lit.size() - litpos) > block_max)
      return ERR_CORRUPT;
    hist.insert(hist.end(), lit.begin() + int64_t(litpos), lit.end());
    return OK;
  }

  // one block's content; its output appended to `hist`
  int block(int type, const uint8_t* src, int64_t csize, int64_t size) {
    if (type == 0) {
      if (uint64_t(csize) > block_max) return ERR_CORRUPT;
      hist.insert(hist.end(), src, src + csize);
      return OK;
    }
    if (type == 1) {
      if (uint64_t(size) > block_max) return ERR_CORRUPT;
      hist.insert(hist.end(), size_t(size), src[0]);
      return OK;
    }
    if (uint64_t(csize) > block_max) return ERR_CORRUPT;
    if (csize < 2) return ERR_CORRUPT;
    std::vector<uint8_t> lit;
    int64_t used = 0;
    int st = literals(src, csize, &lit, &used);
    if (st) return st;
    return sequences(src + used, csize - used, lit, nullptr);
  }
};

// ZSTD_getFrameHeader and ZSTD_decodeFrameHeader
int frame_header(const uint8_t* src, int64_t n, Frame* f) {
  if (n < 5) return ERR_SHORT;
  const uint8_t fhd = src[4];
  const int dict_size = (fhd & 3) == 3 ? 4 : (fhd & 3);
  const bool single = (fhd >> 5) & 1;
  const int fcs_id = fhd >> 6;
  const int fcs_size = fcs_id == 0 ? (single ? 1 : 0) : 1 << fcs_id;
  const int hs = 5 + (single ? 0 : 1) + dict_size + fcs_size;
  if (n < hs) return ERR_SHORT;
  if (fhd & 0x08) return ERR_UNSUPPORTED;
  int pos = 5;
  uint64_t window = 0;
  if (!single) {
    const uint8_t wl = src[pos++];
    const int wlog = (wl >> 3) + 10;
    if (wlog > 31) return ERR_WINDOW;
    window = uint64_t(1) << wlog;
    window += (window >> 3) * (wl & 7);
  }
  uint32_t dict = 0;
  if (dict_size == 1) dict = src[pos];
  if (dict_size == 2) dict = rd16(src + pos);
  if (dict_size == 4) dict = rd32(src + pos);
  pos += dict_size;
  int64_t content = -1;
  if (fcs_size == 1) content = src[pos];
  if (fcs_size == 2) content = int64_t(rd16(src + pos)) + 256;
  if (fcs_size == 4) content = rd32(src + pos);
  if (fcs_size == 8) content = int64_t(rd64(src + pos));
  if (single) window = uint64_t(content);
  if (dict) return ERR_DICTIONARY;
  f->window = window;
  f->block_max = window < kBlockMax ? window : kBlockMax;
  f->content = content;
  f->checksum = (fhd >> 2) & 1;
  f->header = hs;
  return OK;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or -1 where its blocks
// do not lie whole in the data
int64_t frame_size(const uint8_t* src, int64_t n, const Frame& f) {
  int64_t pos = f.header;
  for (;;) {
    if (pos + 3 > n) return -1;
    const uint32_t bh = src[pos] | (uint32_t(src[pos + 1]) << 8) |
                        (uint32_t(src[pos + 2]) << 16);
    const int type = (bh >> 1) & 3;
    if (type == 3) return -1;
    const int64_t csize = type == 1 ? 1 : (bh >> 3);
    pos += 3 + csize;
    if (pos > n) return -1;
    if (bh & 1) break;
  }
  if (f.checksum) pos += 4;
  return pos > n ? -1 : pos;
}

}  // namespace

extern "C" {

// One ZSTD-coded strip into `out` (`occ` bytes); `written` the bytes
// libtiff's buffer holds from the decoder (the rest it zeroes).
int ecgmm_zstd_strip(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ,
                     int64_t* written) {
  *written = 0;
  if (n < 4) return ERR_SHORT;
  const uint32_t magic = rd32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    // a skippable frame ends the call: libtiff sees the frame end with
    // its buffer not full
    return ERR_SHORT;
  }
  if (magic != 0xFD2FB528u) return ERR_PREFIX;
  Frame f;
  int st = frame_header(src, n, &f);
  if (st) return st;
  Decoder d;
  d.block_max = f.block_max;
  const bool one_pass = f.content >= 0 && f.content <= occ &&
                        frame_size(src, n, f) >= 0;
  if (!one_pass) {
    const uint64_t w = f.window < 1024 ? 1024 : f.window;
    if (w > kWindowLimit) return ERR_WINDOW;
  }
  int64_t pos = f.header;
  int64_t flushed = 0;   // bytes of hist copied to out
  bool full = false;     // out filled exactly at a block's end
  for (;;) {
    if (pos + 3 > n) return full ? OK : ERR_SHORT;
    const uint32_t bh = src[pos] | (uint32_t(src[pos + 1]) << 8) |
                        (uint32_t(src[pos + 2]) << 16);
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const int64_t size = bh >> 3;
    if (type == 3) return ERR_CORRUPT;
    const int64_t csize = type == 1 ? 1 : size;
    if (pos + 3 + csize > n) return full ? OK : ERR_SHORT;
    st = d.block(type, src + pos + 3, csize, size);
    if (st) return st;
    pos += 3 + csize;
    // the frame's end is checked before the block is copied out
    if (last && f.content >= 0 && int64_t(d.hist.size()) != f.content)
      return ERR_CORRUPT;
    const int64_t have = int64_t(d.hist.size());
    if (one_pass && have > occ) return ERR_CORRUPT;  // dstSize_tooSmall
    const int64_t take = (have < occ ? have : occ) - flushed;
    if (take > 0) {
      std::memcpy(out + flushed, d.hist.data() + flushed, size_t(take));
      flushed += take;
      *written = flushed;
    }
    if (!one_pass) {
      if (full || have > occ) return OK;  // nothing more is copied out
      full = flushed == occ;
    }
    if (last) break;
  }
  if (f.checksum) {
    if (pos + 4 > n) return full ? OK : (one_pass ? ERR_CHECKSUM : ERR_SHORT);
    const uint32_t want = uint32_t(xxh64(d.hist.data(), d.hist.size()));
    if (rd32(src + pos) != want) return ERR_CHECKSUM;
  }
  return flushed == occ ? OK : ERR_SHORT;
}

}  // extern "C"
