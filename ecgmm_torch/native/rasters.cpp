// The run decoders of the small upload formats (`serve/rasters.py`), each
// as Pillow 12 decodes it: PackBits as Pillow's own PackBitsDecode.c reads
// a PSD channel, TGA's run lengths (TgaRleDecode.c) and QOI's ops
// (QoiImagePlugin.QoiDecoder, which is Python in Pillow). The headers are
// parsed in Python; these loops write rows of bytes, which the caller
// unpacks.

#include <cstdint>
#include <cstring>

namespace {

constexpr int ERR_OVERRUN = -40;   // Pillow: buffer overrun
constexpr int ERR_TRUNCATED = -41;  // the data ends before the last row
constexpr int ERR_QOI_SHORT = -42;  // a QOI op cut by the end of the data

}  // namespace

extern "C" {

// Pillow's PackBitsDecode: `rows` rows of `row_bytes` from `bp`; each run
// or literal fills the current row and what passes its end is dropped;
// 0x80 is no operation. A run or literal must be whole in the data (else
// Pillow waits for more, and at the end of the file the image is
// truncated). `used` is the bytes read.
int ecgmm_pil_packbits(const uint8_t* bp, int64_t n, int64_t row_bytes,
                       int64_t rows, uint8_t* out, int64_t* used) {
  const uint8_t* p = bp;
  const uint8_t* end = bp + n;
  int64_t x = 0, y = 0;
  if (rows <= 0 || row_bytes <= 0) return 0;
  for (;;) {
    if (p >= end) {
      *used = p - bp;
      return ERR_TRUNCATED;
    }
    uint8_t* row = out + y * row_bytes;
    if (p[0] & 0x80) {
      if (p[0] == 0x80) {
        ++p;
        continue;
      }
      if (end - p < 2) {
        *used = p - bp;
        return ERR_TRUNCATED;
      }
      for (int k = 257 - p[0]; k > 0 && x < row_bytes; --k) row[x++] = p[1];
      p += 2;
    } else {
      const int64_t k = int64_t(p[0]) + 1;
      if (end - p < k + 1) {
        *used = p - bp;
        return ERR_TRUNCATED;
      }
      for (int64_t i = 0; i < k && x < row_bytes; ++i) row[x++] = p[1 + i];
      p += k + 1;
    }
    if (x >= row_bytes) {
      x = 0;
      if (++y >= rows) {
        *used = p - bp;
        return 0;
      }
    }
  }
}

// TgaRleDecode: packets of `depth` bytes a pixel; a run (high bit) must
// end inside the row it starts in, a literal runs on into the next rows.
// Rows are written in the order they are decoded; the caller places them.
// A packet must be whole in the data; the image ends at its last row.
int ecgmm_tga_rle(const uint8_t* bp, int64_t n, int depth, int64_t row_bytes,
                  int64_t rows, uint8_t* out) {
  const uint8_t* p = bp;
  const uint8_t* end = bp + n;
  const int64_t total = row_bytes * rows;
  int64_t pos = 0;  // bytes of the image written
  if (depth <= 0 || total <= 0) return ERR_TRUNCATED;
  while (pos < total) {
    if (p >= end) return ERR_TRUNCATED;
    const int64_t k = int64_t(depth) * ((p[0] & 0x7f) + 1);
    if (p[0] & 0x80) {
      if (end - p < 1 + depth) return ERR_TRUNCATED;
      if (pos % row_bytes + k > row_bytes) return ERR_OVERRUN;
      for (int64_t i = 0; i < k; i += depth)
        std::memcpy(out + pos + i, p + 1, size_t(depth));
      pos += k;
      p += 1 + depth;
    } else {
      if (end - p < 1 + k) return ERR_TRUNCATED;
      const int64_t m = k < total - pos ? k : total - pos;
      std::memcpy(out + pos, p + 1, size_t(m));
      pos += m;
      p += 1 + k;
    }
  }
  return 0;
}

// QoiDecoder.decode: `pixels` pixels of `bands` bytes (3 or 4) into `out`.
// The previous pixel starts (0, 0, 0, 255); an index op whose slot was never
// filled reads (0, 0, 0, 0); every op but a run stores its pixel in the slot
// of its hash; a run repeats the previous pixel and stores nothing. An op
// cut by the end of the data fails, as the plugin's reads fail there.
int ecgmm_qoi(const uint8_t* bp, int64_t n, int bands, int64_t pixels,
              uint8_t* out) {
  uint8_t seen[64][4];
  bool filled[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  const uint8_t* p = bp;
  const uint8_t* end = bp + n;
  int64_t done = 0;
  std::memset(seen, 0, sizeof(seen));
  while (done < pixels) {
    if (p >= end) return ERR_QOI_SHORT;
    const uint8_t b = *p++;
    uint8_t v[4];
    if (b == 0xFE) {
      if (end - p < 3) return ERR_QOI_SHORT;
      v[0] = p[0], v[1] = p[1], v[2] = p[2], v[3] = prev[3];
      p += 3;
    } else if (b == 0xFF) {
      if (end - p < 4) return ERR_QOI_SHORT;
      std::memcpy(v, p, 4);
      p += 4;
    } else if ((b >> 6) == 0) {
      if (filled[b & 63])
        std::memcpy(v, seen[b & 63], 4);
      else
        std::memset(v, 0, 4);
    } else if ((b >> 6) == 1) {
      v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (p >= end) return ERR_QOI_SHORT;
      const uint8_t c = *p++;
      const int dg = (b & 63) - 32;
      v[0] = uint8_t(prev[0] + dg + ((c >> 4) & 15) - 8);
      v[1] = uint8_t(prev[1] + dg);
      v[2] = uint8_t(prev[2] + dg + (c & 15) - 8);
      v[3] = prev[3];
    } else {
      for (int r = (b & 63) + 1; r > 0 && done < pixels; --r, ++done)
        std::memcpy(out + done * bands, prev, size_t(bands));
      continue;
    }
    std::memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[h], v, 4);
    filled[h] = true;
    std::memcpy(out + done * bands, v, size_t(bands));
    ++done;
  }
  return 0;
}

}  // extern "C"
