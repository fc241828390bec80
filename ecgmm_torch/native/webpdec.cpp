// Host kernels of the upload decoder's WebP path (ecgmm_torch/serve/imdecode.py):
// the VP8 (lossy) and VP8L (lossless) bitstreams of one frame and the alpha
// plane of its ALPH chunk, decoded as libwebp 1.6 decodes them for Pillow's
// `Image.open` (the animation decoder, output mode RGBA), so that the RGB
// result is bit-equal:
//
// - VP8: the boolean decoder, the segment, filter and quantiser headers
//   (libwebp's DC and AC tables and its y2 and uv clamps), the token
//   partitions, the coefficient tokens, the intra predictors with libwebp's
//   edge values (127 above the frame, 129 left of it), the inverse WHT and
//   DCT in its integer forms (the DCT of most blocks as libwebp's x86
//   build computes it, in 16-bit lanes), the simple and normal loop
//   filters, then the "fancy" upsampling of the 4:2:0 chroma and the
//   14-bit fixed-point YUV->RGB conversion;
// - VP8L: the transforms (predictor, cross-colour, subtract-green, colour
//   indexing), the colour cache, the meta prefix codes, LZ77 with the
//   120-entry distance map, with libwebp's bit reader, so that a stream that
//   runs out of bits is refused exactly where libwebp refuses it;
// - ALPH: raw or headerless-VP8L alpha, then the horizontal, vertical or
//   gradient unfilter.
//
// The RIFF container (chunks, VP8X, ANMF) is parsed in Python, which checks
// every size before it passes a pointer; every read here stays inside the
// buffer it was given. Plain C interface, loaded with ctypes. Every entry
// point returns 0 on success and a negative code otherwise (ERR_* below).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum {
  ERR_VP8_HEADER = -20,
  ERR_VP8_PARTITION0 = -21,
  ERR_VP8_TOKENS = -22,
  ERR_VP8_PARTITIONS = -23,
  ERR_VP8L = -24,
  ERR_ALPH = -25,
  ERR_SIZE = -26,
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------------ VP8

// libwebp's VP8BitReader: 7 bytes a load while 8 remain, then one at a
// time; `eof` is set by the first load that finds the buffer empty, and
// libwebp refuses a frame whose partitions set it
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  int eof = 0;

  void init(const uint8_t* start, size_t size) {
    range = 255 - 1;
    value = 0;
    bits = -8;
    eof = 0;
    buf = start;
    end = start + size;
    load();
  }
  void load() {
    if (end - buf >= 8) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = in | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;  // as libwebp: no shift by a negative count
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // libwebp's VP8GetSigned: a bit at probability 1/2 giving +v or -v
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(bit(0x80)) << n;
    return v;
  }
  int32_t signed_value(int n) {
    const int v = int(value_bits(n));
    return bit(0x80) ? -v : v;
  }
};

// libwebp's intra modes: 4x4 modes, then the 16x16 and chroma aliases and
// the DC variants at the frame's edges
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED,
  B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6,
};

const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6,
                                7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // the stride of the reconstruction work buffer
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;

typedef uint8_t Probas[3][11];  // one band: 3 contexts x 11 probabilities

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  uint8_t limit, ilevel, inner, hev_thresh;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct NzContext {
  uint8_t nz, nz_dc;
};

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

int GetLargeValue(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.bit(p[5]);
    }
  } else {
    if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) {
        v += v + br.bit(*tab);
      }
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// the tokens of one 4x4 block from position n; returns the position after
// the last token that was not an end of block (libwebp's GetCoeffs)
int GetCoeffs(BoolReader& br, const Probas* bands, int ctx, const int dq[2],
              int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const Probas& p_ctx = bands[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = GetLargeValue(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = int16_t(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT added to the prediction (libwebp's TransformOne; its DC-
// only and three-coefficient variants give the same bytes)
void TransformOne(const int16_t* in, uint8_t* dst) {
  int C[4 * 4];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = Mul2(in[4]) - Mul1(in[12]);
    const int d = Mul1(in[4]) + Mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = Mul2(tmp[4]) - Mul1(tmp[12]);
    const int d = Mul1(tmp[4]) + Mul2(tmp[12]);
    dst[0] = uint8_t(clip255(dst[0] + ((a + d) >> 3)));
    dst[1] = uint8_t(clip255(dst[1] + ((b + c) >> 3)));
    dst[2] = uint8_t(clip255(dst[2] + ((b - c) >> 3)));
    dst[3] = uint8_t(clip255(dst[3] + ((a - d) >> 3)));
    tmp++;
    dst += BPS;
  }
}

// libwebp's x86 inverse DCT (`Transform_SSE2`, which Pillow's libwebp
// runs for a block with more than three coefficients and for the chroma
// blocks of a macroblock with any chroma AC): the same formula in 16-bit
// lanes, each sum wrapping and the result added to the prediction in 16
// bits before the unsigned saturation. It equals TransformOne for the
// coefficients an encoder writes; only corrupt data reaches the wrap.
inline int16_t W16(int v) { return int16_t(uint16_t(v)); }
inline int16_t MulHi(int16_t a, int16_t k) {
  return int16_t((int32_t(a) * k) >> 16);
}

void TransformSSE2(const int16_t* in, uint8_t* dst) {
  const int16_t k1 = 20091, k2 = -30068;
  int16_t t[4][4];  // t[i][c]: the vertical pass, row i of column c
  for (int c = 0; c < 4; ++c) {
    const int16_t i0 = in[c], i1 = in[4 + c], i2 = in[8 + c],
                  i3 = in[12 + c];
    const int16_t a = W16(i0 + i2), b = W16(i0 - i2);
    const int16_t cc = W16(W16(i1 - i3) + W16(MulHi(i1, k2) - MulHi(i3, k1)));
    const int16_t d = W16(W16(i1 + i3) + W16(MulHi(i1, k1) + MulHi(i3, k2)));
    t[0][c] = W16(a + d);
    t[1][c] = W16(b + cc);
    t[2][c] = W16(b - cc);
    t[3][c] = W16(a - d);
  }
  for (int i = 0; i < 4; ++i) {  // the horizontal pass, output row i
    const int16_t* r = t[i];
    const int16_t dc = W16(r[0] + 4);
    const int16_t a = W16(dc + r[2]), b = W16(dc - r[2]);
    const int16_t cc = W16(W16(r[1] - r[3]) + W16(MulHi(r[1], k2) -
                                                  MulHi(r[3], k1)));
    const int16_t d = W16(W16(r[1] + r[3]) + W16(MulHi(r[1], k1) +
                                                 MulHi(r[3], k2)));
    const int16_t out[4] = {int16_t(W16(a + d) >> 3), int16_t(W16(b + cc) >> 3),
                            int16_t(W16(b - cc) >> 3), int16_t(W16(a - d) >> 3)};
    for (int x = 0; x < 4; ++x) {
      dst[x] = uint8_t(clip255(W16(dst[x] + out[x])));
    }
    dst += BPS;
  }
}

// a luma block by its code (libwebp's DoTransform): 3 (more than three
// coefficients) the x86 transform, 2 and 1 the C forms, which TransformOne
// computes exactly; 0 nothing
inline void DoTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3:
      TransformSSE2(src, dst);
      break;
    case 2:
    case 1:
      TransformOne(src, dst);
      break;
    default:
      break;
  }
}

// ---- intra predictors on the work buffer (stride BPS)

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) (uint8_t(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      dst[x] = uint8_t(clip255(top[x] + dst[-1] - top[-1]));
    }
    dst += BPS;
  }
}

void Put(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void PredLuma16(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      Put(dst, dc >> 5, 16);
      break;
    case TM_PRED:
      TrueMotion(dst, 16);
      break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case B_DC_PRED_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      Put(dst, dc >> 4, 16);
      break;
    case B_DC_PRED_NOLEFT:
      dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      Put(dst, dc >> 4, 16);
      break;
    default:  // B_DC_PRED_NOTOPLEFT
      Put(dst, 0x80, 16);
      break;
  }
}

void PredChroma8(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      Put(dst, dc >> 4, 8);
      break;
    case TM_PRED:
      TrueMotion(dst, 8);
      break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case B_DC_PRED_NOTOP:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      Put(dst, dc >> 3, 8);
      break;
    case B_DC_PRED_NOLEFT:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      Put(dst, dc >> 3, 8);
      break;
    default:
      Put(dst, 0x80, 8);
      break;
  }
}

void PredLuma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      Put(dst, int(dc), 4);
      break;
    }
    case B_TM_PRED:
      TrueMotion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {
          AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
          AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS];
      const int D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      std::memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      std::memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      std::memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
      const int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS];
      const int C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
      const int D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS];
      const int G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
      const int K = dst[-1 + 2 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS];
      const int C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
      const int D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS];
      const int G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
      const int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS];
      const int C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
      const int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = uint8_t(L);
      break;
    }
  }
}

#undef DST
#undef AVG3
#undef AVG2

// ---- loop filters on the decoded planes

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = uint8_t(clip255(p0 + a2));
  p[0] = uint8_t(clip255(q0 - a1));
}

inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = uint8_t(clip255(p1 + a3));
  p[-step] = uint8_t(clip255(p0 + a2));
  p[0] = uint8_t(clip255(q0 - a1));
  p[step] = uint8_t(clip255(q1 - a3));
}

inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = uint8_t(clip255(p2 + a3));
  p[-2 * step] = uint8_t(clip255(p1 + a2));
  p[-step] = uint8_t(clip255(p0 + a1));
  p[0] = uint8_t(clip255(q0 - a1));
  p[step] = uint8_t(clip255(q1 - a2));
  p[2 * step] = uint8_t(clip255(q2 - a3));
}

inline int Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void SimpleFilter16(uint8_t* p, int step, int across, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (NeedsFilter(p + i * across, step, thresh2)) {
      DoFilter2(p + i * across, step);
    }
  }
}

// `hstride` steps across the edge, `vstride` along it; `six` chooses the
// macroblock-edge filter (6 taps) over the inner-edge one (4 taps)
void FilterLoop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                int ithresh, int hev_thresh, bool six) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) {
        DoFilter2(p, hstride);
      } else if (six) {
        DoFilter6(p, hstride);
      } else {
        DoFilter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_proba[3] = {255, 255, 255};
  // filter header
  int filter_simple = 0, filter_level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  Quant dqm[4];
  Probas bands[4][8];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  bool ParseSegmentHeader() {
    use_segment = br.bit(0x80);
    if (use_segment) {
      update_map = br.bit(0x80);
      if (br.bit(0x80)) {  // update data
        absolute_delta = br.bit(0x80);
        for (int s = 0; s < 4; ++s)
          quantizer[s] = br.bit(0x80) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength[s] = br.bit(0x80) ? br.signed_value(6) : 0;
      }
      if (update_map) {
        for (int s = 0; s < 3; ++s)
          segment_proba[s] = br.bit(0x80) ? uint8_t(br.value_bits(8)) : 255;
      }
    } else {
      update_map = 0;
    }
    return !br.eof;
  }

  bool ParseFilterHeader() {
    filter_simple = br.bit(0x80);
    filter_level = int(br.value_bits(6));
    sharpness = int(br.value_bits(3));
    use_lf_delta = br.bit(0x80);
    if (use_lf_delta) {
      if (br.bit(0x80)) {  // update lf-delta?
        for (int i = 0; i < 4; ++i)
          if (br.bit(0x80)) ref_lf_delta[i] = br.signed_value(6);
        for (int i = 0; i < 4; ++i)
          if (br.bit(0x80)) mode_lf_delta[i] = br.signed_value(6);
      }
    }
    filter_type = (filter_level == 0) ? 0 : filter_simple ? 1 : 2;
    return !br.eof;
  }

  // the token partitions after the first; the last runs to the end and
  // must hold at least one byte
  bool ParsePartitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    size_t size_left = size;
    num_parts_minus_one = (1 << br.value_bits(2)) - 1;
    const size_t last_part = size_t(num_parts_minus_one);
    if (size < 3 * last_part) return false;
    const uint8_t* part_start = buf + last_part * 3;
    size_left -= last_part * 3;
    for (size_t p = 0; p < last_part; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    return part_start < buf_end;
  }

  void ParseQuant() {
    const int base_q0 = int(br.value_bits(7));
    const int dqy1_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dquv_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dquv_ac = br.bit(0x80) ? br.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q + 0, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      // x * 155 / 100 as libwebp computes it
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void ParseProba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int v = br.bit(kCoeffsUpdateProba[t][b][c][p])
                              ? int(br.value_bits(8))
                              : kCoeffsProba0[t][b][c][p];
            bands[t][b][c][p] = uint8_t(v);
          }
    use_skip_proba = br.bit(0x80);
    if (use_skip_proba) skip_p = int(br.value_bits(8));
  }

  void PrecomputeFilterStrengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += filter_level;
      } else {
        base_level = filter_level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int level = base_level;
        if (use_lf_delta) {
          level += ref_lf_delta[0];
          if (i4x4) level += mode_lf_delta[0];
        }
        level = (level < 0) ? 0 : (level > 63) ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness > 0) {
            if (sharpness > 4) {
              ilevel >>= 2;
            } else {
              ilevel >>= 1;
            }
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = uint8_t(ilevel);
          info.limit = uint8_t(2 * level + ilevel);
          info.hev_thresh = (level >= 40) ? 2 : (level >= 15) ? 1 : 0;
        } else {
          info.limit = 0;  // no filtering
        }
        info.inner = uint8_t(i4x4);
      }
    }
  }

  void ParseIntraMode(MBData* block, uint8_t* top, uint8_t* left) {
    if (update_map) {
      block->segment = !br.bit(segment_proba[0])
                           ? uint8_t(br.bit(segment_proba[1]))
                           : uint8_t(br.bit(segment_proba[2]) + 2);
    } else {
      block->segment = 0;
    }
    block->skip = use_skip_proba ? uint8_t(br.bit(skip_p)) : 0;
    block->is_i4x4 = !br.bit(145);
    if (!block->is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                    : (br.bit(163) ? V_PRED : DC_PRED);
      block->imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block->imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
          ymode = -i;
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    block->uvmode = !br.bit(142)   ? DC_PRED
                    : !br.bit(114) ? V_PRED
                    : br.bit(183)  ? TM_PRED
                                   : H_PRED;
  }

  // returns 1 when the macroblock has no non-zero coefficient
  int ParseResiduals(NzContext* mb, NzContext* left_mb, MBData* block,
                     BoolReader& token_br) {
    const Quant& q = dqm[block->segment];
    int16_t* dst = block->coeffs;
    const Probas* ac_proba;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first;
    std::memset(dst, 0, 384 * sizeof(*dst));
    if (!block->is_i4x4) {  // parse DC
      int16_t dc[16] = {0};
      const int ctx = mb->nz_dc + left_mb->nz_dc;
      const int nz = GetCoeffs(token_br, bands[1], ctx, q.y2, 0, dc);
      mb->nz_dc = left_mb->nz_dc = uint8_t(nz > 0);
      if (nz > 1) {
        TransformWHT(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      ac_proba = bands[0];
    } else {
      first = 0;
      ac_proba = bands[3];
    }
    uint8_t tnz = mb->nz & 0x0f;
    uint8_t lnz = left_mb->nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = GetCoeffs(token_br, ac_proba, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = uint8_t((tnz >> 1) | (l << 7));
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = uint8_t((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = uint8_t(mb->nz >> (4 + ch));
      lnz = uint8_t(left_mb->nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = GetCoeffs(token_br, bands[2], ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = uint8_t((tnz >> 1) | (l << 3));
          nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = uint8_t((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= uint32_t(tnz << 4) << ch;
      out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    mb->nz = uint8_t(out_t_nz);
    left_mb->nz = uint8_t(out_l_nz);
    block->non_zero_y = non_zero_y;
    block->non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }
};

inline int CheckMode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) {
      return (mb_y == 0) ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    }
    return (mb_y == 0) ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

// libwebp's DoUVTransform: with any AC coefficient the x86 transform on
// all four blocks, else the C DC form on each
void DoUVTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {  // any non-zero coefficient at all
    void (*transform)(const int16_t*, uint8_t*) =
        (bits & 0xaa) ? TransformSSE2 : TransformOne;
    transform(src + 0 * 16, dst);
    transform(src + 1 * 16, dst + 4);
    transform(src + 2 * 16, dst + 4 * BPS);
    transform(src + 3 * 16, dst + 4 * BPS + 4);
  }
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// ---- fancy upsampling and YUV->RGB (libwebp's upsampling.c and yuv.h)

inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int Clip8(int v) {
  return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void YuvToRgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = uint8_t(Clip8(MultHi(y, 19077) + MultHi(v, 26149) - 14234));
  rgb[1] = uint8_t(Clip8(MultHi(y, 19077) - MultHi(u, 6419) -
                         MultHi(v, 13320) + 8708));
  rgb[2] = uint8_t(Clip8(MultHi(y, 19077) + MultHi(u, 33050) - 17685));
}

// one pair of output rows (the bottom one may be absent) from two chroma
// rows; the 9-3-3-1 filter computed per channel as libwebp computes it on
// packed u|v words
void UpsamplePair(const uint8_t* top_y, const uint8_t* bottom_y,
                  const uint8_t* top_u, const uint8_t* top_v,
                  const uint8_t* cur_u, const uint8_t* cur_v,
                  uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0];
  int l_u = cur_u[0], l_v = cur_v[0];
  YuvToRgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
           top_dst);
  if (bottom_y != nullptr) {
    YuvToRgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2,
             (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x];
    const int c_u = cur_u[x], c_v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8;
    const int avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3;
    const int d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    YuvToRgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
             top_dst + (2 * x - 1) * 3);
    YuvToRgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
             top_dst + (2 * x) * 3);
    if (bottom_y != nullptr) {
      YuvToRgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
               bottom_dst + (2 * x - 1) * 3);
      YuvToRgb(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1,
               bottom_dst + (2 * x) * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(len & 1)) {
    YuvToRgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2,
             (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y != nullptr) {
      YuvToRgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
               (3 * l_v + tl_v + 2) >> 2, bottom_dst + (len - 1) * 3);
    }
  }
}

// the frame's planes to RGB rows in the order libwebp emits them: row 0
// alone, then the pairs (2k-1, 2k), then for an even height the last row
void EmitFancyRGB(const uint8_t* Y, int64_t y_stride, const uint8_t* U,
                  const uint8_t* V, int64_t uv_stride, int width, int height,
                  uint8_t* rgb, int64_t rgb_stride) {
  UpsamplePair(Y, nullptr, U, V, U, V, rgb, nullptr, width);
  int y = 1;
  for (; y + 1 < height; y += 2) {
    const int k = (y + 1) >> 1;
    UpsamplePair(Y + y * y_stride, Y + (y + 1) * y_stride,
                 U + (k - 1) * uv_stride, V + (k - 1) * uv_stride,
                 U + k * uv_stride, V + k * uv_stride, rgb + y * rgb_stride,
                 rgb + (y + 1) * rgb_stride, width);
  }
  if (!(height & 1) && height > 1) {
    const int k = (height - 1) >> 1;
    UpsamplePair(Y + (height - 1) * y_stride, nullptr, U + k * uv_stride,
                 V + k * uv_stride, U + k * uv_stride, V + k * uv_stride,
                 rgb + (height - 1) * rgb_stride, nullptr, width);
  }
}

// Decodes the frame into planes of whole macroblocks, filtering each row
// of macroblocks once it is reconstructed (prediction reads the unfiltered
// samples, kept in the work buffer and `top`, as libwebp keeps them).
int DecodeVP8Frame(VP8Decoder& dec, std::vector<uint8_t>& Yp,
                   std::vector<uint8_t>& Up, std::vector<uint8_t>& Vp) {
  const int mb_w = dec.mb_w, mb_h = dec.mb_h;
  const int64_t y_stride = int64_t(mb_w) * 16, uv_stride = int64_t(mb_w) * 8;
  Yp.assign(size_t(y_stride) * mb_h * 16, 0);
  Up.assign(size_t(uv_stride) * mb_h * 8, 0);
  Vp.assign(size_t(uv_stride) * mb_h * 8, 0);
  std::vector<uint8_t> intra_t(size_t(4) * mb_w, B_DC_PRED);
  uint8_t intra_l[4];
  std::vector<NzContext> nz(size_t(mb_w) + 1, NzContext{0, 0});
  std::vector<MBData> row(mb_w);
  std::vector<FInfo> finfo(mb_w);
  std::vector<TopSamples> top(mb_w);
  uint8_t yuv_b[YUV_SIZE + 64];
  std::memset(yuv_b, 0, sizeof(yuv_b));
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  dec.PrecomputeFilterStrengths();

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& token_br = dec.parts[mb_y & dec.num_parts_minus_one];
    std::memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      dec.ParseIntraMode(&row[mb_x], &intra_t[4 * size_t(mb_x)], intra_l);
    }
    if (dec.br.eof) return ERR_VP8_PARTITION0;
    NzContext* left = &nz[0];
    left->nz = left->nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData* block = &row[mb_x];
      NzContext* mb = &nz[size_t(mb_x) + 1];
      int skip = dec.use_skip_proba ? block->skip : 0;
      if (!skip) {
        skip = dec.ParseResiduals(mb, left, block, token_br);
      } else {
        left->nz = mb->nz = 0;
        if (!block->is_i4x4) left->nz_dc = mb->nz_dc = 0;
        block->non_zero_y = 0;
        block->non_zero_uv = 0;
      }
      if (dec.filter_type > 0) {
        finfo[mb_x] = dec.fstrengths[block->segment][block->is_i4x4];
        finfo[mb_x].inner |= uint8_t(!skip);
      }
      if (token_br.eof) return ERR_VP8_TOKENS;
    }

    // reconstruct the row (libwebp's ReconstructRow)
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData* block = &row[mb_x];
      if (mb_x > 0) {  // rotate in the left samples
        for (int j = -1; j < 16; ++j)
          std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      TopSamples* const top_yuv = &top[mb_x];
      const int16_t* const coeffs = block->coeffs;
      uint32_t bits = block->non_zero_y;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
        std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
        std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (block->is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {  // on the rightmost edge
            std::memset(top_right, top_yuv[0].y[15], 4);
          } else {
            std::memcpy(top_right, top_yuv[1].y, 4);
          }
        }
        // replicate the top-right pixels below
        std::memcpy(top_right + 4 * BPS, top_right, 4);
        std::memcpy(top_right + 8 * BPS, top_right, 4);
        std::memcpy(top_right + 12 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          PredLuma4(block->imodes[n], dst);
          DoTransform(bits, coeffs + n * 16, dst);
        }
      } else {
        PredLuma16(CheckMode(mb_x, mb_y, block->imodes[0]), y_dst);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          DoTransform(bits, coeffs + n * 16,
                      y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
      }
      const uint32_t bits_uv = block->non_zero_uv;
      const int pred_func = CheckMode(mb_x, mb_y, block->uvmode);
      PredChroma8(pred_func, u_dst);
      PredChroma8(pred_func, v_dst);
      DoUVTransform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
      DoUVTransform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h - 1) {  // stash the top samples for the next row
        std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      uint8_t* const y_out = &Yp[size_t(mb_y) * 16 * y_stride + mb_x * 16];
      uint8_t* const u_out = &Up[size_t(mb_y) * 8 * uv_stride + mb_x * 8];
      uint8_t* const v_out = &Vp[size_t(mb_y) * 8 * uv_stride + mb_x * 8];
      for (int j = 0; j < 16; ++j)
        std::memcpy(y_out + j * y_stride, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(u_out + j * uv_stride, u_dst + j * BPS, 8);
        std::memcpy(v_out + j * uv_stride, v_dst + j * BPS, 8);
      }
    }

    // filter the row (libwebp's DoFilter, macroblock by macroblock)
    if (dec.filter_type > 0) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        const int ilevel = f.ilevel;
        const int ys = int(y_stride);
        uint8_t* const yd = &Yp[size_t(mb_y) * 16 * y_stride + mb_x * 16];
        if (dec.filter_type == 1) {  // simple
          if (mb_x > 0) SimpleFilter16(yd, 1, ys, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k)
              SimpleFilter16(yd + 4 * k, 1, ys, limit);
          if (mb_y > 0) SimpleFilter16(yd, ys, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k)
              SimpleFilter16(yd + 4 * k * ys, ys, 1, limit);
        } else {  // complex
          const int uvs = int(uv_stride);
          uint8_t* const ud = &Up[size_t(mb_y) * 8 * uv_stride + mb_x * 8];
          uint8_t* const vd = &Vp[size_t(mb_y) * 8 * uv_stride + mb_x * 8];
          const int hev = f.hev_thresh;
          if (mb_x > 0) {
            FilterLoop(yd, 1, ys, 16, limit + 4, ilevel, hev, true);
            FilterLoop(ud, 1, uvs, 8, limit + 4, ilevel, hev, true);
            FilterLoop(vd, 1, uvs, 8, limit + 4, ilevel, hev, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k)
              FilterLoop(yd + 4 * k, 1, ys, 16, limit, ilevel, hev, false);
            FilterLoop(ud + 4, 1, uvs, 8, limit, ilevel, hev, false);
            FilterLoop(vd + 4, 1, uvs, 8, limit, ilevel, hev, false);
          }
          if (mb_y > 0) {
            FilterLoop(yd, ys, 1, 16, limit + 4, ilevel, hev, true);
            FilterLoop(ud, uvs, 1, 8, limit + 4, ilevel, hev, true);
            FilterLoop(vd, uvs, 1, 8, limit + 4, ilevel, hev, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k)
              FilterLoop(yd + 4 * k * ys, ys, 1, 16, limit, ilevel, hev,
                         false);
            FilterLoop(ud + 4 * uvs, uvs, 1, 8, limit, ilevel, hev, false);
            FilterLoop(vd + 4 * uvs, uvs, 1, 8, limit, ilevel, hev, false);
          }
        }
      }
    }
  }
  return 0;
}

// ------------------------------------------------------------------ VP8L

// libwebp's VP8LBitReader (its byte-by-byte path, which reads the same
// bits as its 32-bit refill): 64 bits of lookahead, `eos` once a read went
// past the last byte
struct LBitReader {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  int eos = 0;

  void init(const uint8_t* start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = 0;
    size_t n = length > 8 ? 8 : length;
    uint64_t value = 0;
    for (size_t i = 0; i < n; ++i) value |= uint64_t(start[i]) << (8 * i);
    val = value;
    pos = n;
    buf = start;
  }
  bool is_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= uint64_t(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (is_end()) set_end();
  }
  uint32_t prefetch() const { return uint32_t(val >> (bit_pos & 63)); }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
  uint32_t read(int n_bits) {
    if (!eos && n_bits <= 24) {
      const uint32_t v = prefetch() & ((1u << n_bits) - 1);
      bit_pos += n_bits;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
};

constexpr int HUFFMAN_TABLE_BITS = 8;
constexpr int LENGTHS_TABLE_BITS = 7;
constexpr int MAX_ALLOWED_CODE_LENGTH = 15;
constexpr int NUM_LITERAL_CODES = 256;
constexpr int NUM_LENGTH_CODES = 24;
constexpr int NUM_DISTANCE_CODES = 40;
constexpr int NUM_CODE_LENGTH_CODES = 19;
const int kAlphabetSize[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES,
                              NUM_LITERAL_CODES, NUM_LITERAL_CODES,
                              NUM_LITERAL_CODES, NUM_DISTANCE_CODES};
const uint8_t kCodeLengthCodeOrder[NUM_CODE_LENGTH_CODES] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum {
  PREDICTOR_TRANSFORM = 0,
  CROSS_COLOR_TRANSFORM = 1,
  SUBTRACT_GREEN_TRANSFORM = 2,
  COLOR_INDEXING_TRANSFORM = 3,
};

struct HuffmanCode {
  uint8_t bits;
  uint16_t value;
};

inline uint32_t GetNextKey(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void ReplicateValue(HuffmanCode* table, int step, int end, HuffmanCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int NextTableBitSize(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < MAX_ALLOWED_CODE_LENGTH) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: 0 for an invalid code (all lengths zero,
// over-subscribed or incomplete), else the size of the two-level table;
// `root_table` null only checks and sizes
int BuildHuffmanTable(HuffmanCode* root_table, int root_bits,
                      const int* code_lengths, int code_lengths_size) {
  HuffmanCode* table = root_table;
  int total_size = 1 << root_bits;
  int count[MAX_ALLOWED_CODE_LENGTH + 1] = {0};
  int offset[MAX_ALLOWED_CODE_LENGTH + 1];
  std::vector<uint16_t> sorted;
  for (int symbol = 0; symbol < code_lengths_size; ++symbol) {
    if (code_lengths[symbol] > MAX_ALLOWED_CODE_LENGTH) return 0;
    ++count[code_lengths[symbol]];
  }
  if (count[0] == code_lengths_size) return 0;
  offset[1] = 0;
  for (int len = 1; len < MAX_ALLOWED_CODE_LENGTH; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  if (root_table != nullptr) sorted.resize(size_t(code_lengths_size));
  for (int symbol = 0; symbol < code_lengths_size; ++symbol) {
    const int l = code_lengths[symbol];
    if (l > 0) {
      if (root_table != nullptr) sorted[size_t(offset[l])] = uint16_t(symbol);
      offset[l]++;
    }
  }
  if (offset[MAX_ALLOWED_CODE_LENGTH] == 1) {  // one symbol: no bits
    if (root_table != nullptr) {
      HuffmanCode code;
      code.bits = 0;
      code.value = sorted[0];
      ReplicateValue(table, 1, total_size, code);
    }
    return total_size;
  }
  int step;
  uint32_t low = 0xffffffffu;
  const uint32_t mask = uint32_t(total_size - 1);
  uint32_t key = 0;
  int num_nodes = 1;
  int num_open = 1;
  int table_bits = root_bits;
  int table_size = 1 << table_bits;
  int symbol = 0;
  int len;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (root_table == nullptr) continue;
    for (; count[len] > 0; --count[len]) {
      HuffmanCode code;
      code.bits = uint8_t(len);
      code.value = sorted[size_t(symbol++)];
      ReplicateValue(&table[key], step, table_size, code);
      key = GetNextKey(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= MAX_ALLOWED_CODE_LENGTH;
       ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root_table != nullptr) table += table_size;
        table_bits = NextTableBitSize(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root_table != nullptr) {
          root_table[low].bits = uint8_t(table_bits + root_bits);
          root_table[low].value = uint16_t((table - root_table) - low);
        }
      }
      if (root_table != nullptr) {
        HuffmanCode code;
        code.bits = uint8_t(len - root_bits);
        code.value = sorted[size_t(symbol++)];
        ReplicateValue(&table[key >> root_bits], step, table_size, code);
      }
      key = GetNextKey(key, len);
    }
  }
  if (num_nodes != 2 * offset[MAX_ALLOWED_CODE_LENGTH] - 1) return 0;
  return total_size;
}

// a checked code built into its own table; empty when invalid
std::vector<HuffmanCode> MakeTable(int root_bits, const int* lengths, int n) {
  std::vector<HuffmanCode> t;
  const int size = BuildHuffmanTable(nullptr, root_bits, lengths, n);
  if (size == 0) return t;
  t.assign(size_t(size), HuffmanCode{0, 0});
  BuildHuffmanTable(t.data(), root_bits, lengths, n);
  return t;
}

inline int ReadSymbol(const HuffmanCode* table, LBitReader& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << HUFFMAN_TABLE_BITS) - 1);
  const int nbits = table->bits - HUFFMAN_TABLE_BITS;
  if (nbits > 0) {
    br.bit_pos += HUFFMAN_TABLE_BITS;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

struct HTreeGroup {
  std::vector<HuffmanCode> htrees[5];
  bool multi[5];  // the code has more than one symbol
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Metadata {
  int color_cache_size = 0;
  int hash_shift = 0;
  std::vector<uint32_t> color_cache;
  int huffman_subsample_bits = 0;
  int huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<HTreeGroup> groups;
};

inline int SubSampleSize(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline int GetCopyDistance(int distance_symbol, LBitReader& br) {
  if (distance_symbol < 4) return distance_symbol + 1;
  const int extra_bits = (distance_symbol - 2) >> 1;
  const int offset = (2 + (distance_symbol & 1)) << extra_bits;
  return offset + int(br.read(extra_bits)) + 1;
}

inline int PlaneCodeToDistance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return (dist >= 1) ? dist : 1;
}

struct VP8LDecoder {
  LBitReader br;
  Transform transforms[4];
  int next_transform = 0;
  uint32_t transforms_seen = 0;
  int width = 0, height = 0;  // of the level-0 image after its transforms
  Metadata hdr;

  bool ReadHuffmanCodeLengths(const int* code_length_code_lengths,
                              int num_symbols, int* code_lengths) {
    const std::vector<HuffmanCode> table =
        MakeTable(LENGTHS_TABLE_BITS, code_length_code_lengths,
                  NUM_CODE_LENGTH_CODES);
    if (table.empty()) return false;
    int max_symbol;
    int prev_code_len = 8;
    if (br.read(1)) {  // use length
      const int length_nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(length_nbits));
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    int symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const HuffmanCode* p =
          &table[br.prefetch() & ((1u << LENGTHS_TABLE_BITS) - 1)];
      br.bit_pos += p->bits;
      const int code_len = p->value;
      if (code_len < 16) {
        code_lengths[symbol++] = code_len;
        if (code_len != 0) prev_code_len = code_len;
      } else {
        const int use_prev = (code_len == 16);
        const int slot = code_len - 16;
        static const int kExtraBits[3] = {2, 3, 7};
        static const int kRepeatOffsets[3] = {3, 3, 11};
        int repeat = int(br.read(kExtraBits[slot])) + kRepeatOffsets[slot];
        if (symbol + repeat > num_symbols) return false;
        const int length = use_prev ? prev_code_len : 0;
        while (repeat-- > 0) code_lengths[symbol++] = length;
      }
    }
    return true;
  }

  // one prefix code; false when invalid or the stream ran out
  bool ReadHuffmanCode(int alphabet_size, std::vector<int>& code_lengths,
                       std::vector<HuffmanCode>* out) {
    const int simple_code = int(br.read(1));
    std::memset(code_lengths.data(), 0, size_t(alphabet_size) * sizeof(int));
    bool ok;
    if (simple_code) {
      const int num_symbols = int(br.read(1)) + 1;
      const int first_symbol_len_code = int(br.read(1));
      int symbol = int(br.read(first_symbol_len_code == 0 ? 1 : 8));
      code_lengths[size_t(symbol)] = 1;
      if (num_symbols == 2) {
        symbol = int(br.read(8));
        code_lengths[size_t(symbol)] = 1;
      }
      ok = true;
    } else {
      int code_length_code_lengths[NUM_CODE_LENGTH_CODES] = {0};
      const int num_codes = int(br.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i) {
        code_length_code_lengths[kCodeLengthCodeOrder[i]] = int(br.read(3));
      }
      ok = ReadHuffmanCodeLengths(code_length_code_lengths, alphabet_size,
                                  code_lengths.data());
    }
    ok = ok && !br.eos;
    if (!ok) return false;
    if (out == nullptr) {
      return BuildHuffmanTable(nullptr, HUFFMAN_TABLE_BITS,
                               code_lengths.data(), alphabet_size) != 0;
    }
    *out = MakeTable(HUFFMAN_TABLE_BITS, code_lengths.data(), alphabet_size);
    return !out->empty();
  }

  bool ReadHuffmanCodes(Metadata& h, int xsize, int ysize,
                        int color_cache_bits, bool allow_recursion) {
    int num_htree_groups = 1;
    int num_htree_groups_max = 1;
    std::vector<int> mapping;
    if (allow_recursion && br.read(1)) {  // meta prefix codes
      const int huffman_precision = 2 + int(br.read(3));
      const int huffman_xsize = SubSampleSize(xsize, huffman_precision);
      const int huffman_ysize = SubSampleSize(ysize, huffman_precision);
      const int64_t huffman_pixs = int64_t(huffman_xsize) * huffman_ysize;
      if (!DecodeImageStream(huffman_xsize, huffman_ysize, false,
                             &h.huffman_image)) {
        return false;
      }
      h.huffman_subsample_bits = huffman_precision;
      for (int64_t i = 0; i < huffman_pixs; ++i) {
        const int group = int((h.huffman_image[size_t(i)] >> 8) & 0xffff);
        h.huffman_image[size_t(i)] = uint32_t(group);
        if (group >= num_htree_groups_max) num_htree_groups_max = group + 1;
      }
      if (num_htree_groups_max > 1000 ||
          num_htree_groups_max > int64_t(xsize) * ysize) {
        mapping.assign(size_t(num_htree_groups_max), -1);
        num_htree_groups = 0;
        for (int64_t i = 0; i < huffman_pixs; ++i) {
          int& mapped = mapping[h.huffman_image[size_t(i)]];
          if (mapped == -1) mapped = num_htree_groups++;
          h.huffman_image[size_t(i)] = uint32_t(mapped);
        }
      } else {
        num_htree_groups = num_htree_groups_max;
      }
    }
    if (br.eos) return false;
    const int max_alphabet_size =
        kAlphabetSize[0] + (color_cache_bits > 0 ? 1 << color_cache_bits : 0);
    // at least 256 entries: a simple code may name any 8-bit symbol
    std::vector<int> code_lengths(size_t(max_alphabet_size), 0);
    h.groups.assign(size_t(num_htree_groups), HTreeGroup());
    for (int i = 0; i < num_htree_groups_max; ++i) {
      const bool unused = !mapping.empty() && mapping[size_t(i)] == -1;
      HTreeGroup* group =
          unused ? nullptr
                 : &h.groups[size_t(mapping.empty() ? i : mapping[size_t(i)])];
      for (int j = 0; j < 5; ++j) {
        int alphabet_size = kAlphabetSize[j];
        if (j == 0 && color_cache_bits > 0) {
          alphabet_size += 1 << color_cache_bits;
        }
        if (!ReadHuffmanCode(alphabet_size, code_lengths,
                             group ? &group->htrees[j] : nullptr)) {
          return false;
        }
        if (group) group->multi[j] = group->htrees[j][0].bits > 0;
      }
    }
    return true;
  }

  bool ReadTransform(int* xsize, int ysize) {
    const int type = int(br.read(2));
    if (transforms_seen & (1u << type)) return false;
    transforms_seen |= 1u << type;
    Transform& t = transforms[next_transform++];
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    t.bits = 0;
    t.data.clear();
    switch (type) {
      case PREDICTOR_TRANSFORM:
      case CROSS_COLOR_TRANSFORM:
        t.bits = 2 + int(br.read(3));
        return DecodeImageStream(SubSampleSize(t.xsize, t.bits),
                                 SubSampleSize(t.ysize, t.bits), false,
                                 &t.data);
      case COLOR_INDEXING_TRANSFORM: {
        const int num_colors = int(br.read(8)) + 1;
        const int bits = (num_colors > 16)  ? 0
                         : (num_colors > 4) ? 1
                         : (num_colors > 2) ? 2
                                            : 3;
        *xsize = SubSampleSize(t.xsize, bits);
        t.bits = bits;
        std::vector<uint32_t> colors;
        if (!DecodeImageStream(num_colors, 1, false, &colors)) return false;
        // the palette is delta-coded; entries past it are transparent black
        const int final_num_colors = 1 << (8 >> bits);
        t.data.assign(size_t(final_num_colors), 0);
        uint8_t* const dst = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* const src =
            reinterpret_cast<const uint8_t*>(colors.data());
        t.data[0] = colors[0];
        for (int i = 4; i < 4 * num_colors; ++i) {
          dst[i] = uint8_t((src[i] + dst[i - 4]) & 0xff);
        }
        return true;
      }
      default:  // SUBTRACT_GREEN_TRANSFORM
        return true;
    }
  }

  // libwebp's DecodeImageStream: the transforms (level 0 only), the colour
  // cache, the prefix codes, then (below level 0) the entropy-coded pixels
  bool DecodeImageStream(int xsize, int ysize, bool is_level0,
                         std::vector<uint32_t>* decoded) {
    int transform_xsize = xsize;
    const int transform_ysize = ysize;
    int color_cache_bits = 0;
    if (is_level0) {
      while (br.read(1)) {
        if (!ReadTransform(&transform_xsize, transform_ysize)) return false;
      }
    }
    if (br.read(1)) {
      color_cache_bits = int(br.read(4));
      if (!(color_cache_bits >= 1 && color_cache_bits <= 11)) return false;
    }
    Metadata h;
    if (!ReadHuffmanCodes(h, transform_xsize, transform_ysize,
                          color_cache_bits, is_level0)) {
      return false;
    }
    if (color_cache_bits > 0) {
      h.color_cache_size = 1 << color_cache_bits;
      h.hash_shift = 32 - color_cache_bits;
      h.color_cache.assign(size_t(h.color_cache_size), 0);
    }
    h.huffman_xsize = SubSampleSize(transform_xsize, h.huffman_subsample_bits);
    if (is_level0) {
      width = transform_xsize;
      height = transform_ysize;
      hdr = std::move(h);
      return true;
    }
    decoded->assign(size_t(transform_xsize) * size_t(transform_ysize), 0);
    return DecodeImageData(h, decoded->data(), transform_xsize,
                           transform_ysize) &&
           !br.eos;
  }

  const HTreeGroup& GroupAt(const Metadata& h, int x, int y) const {
    if (h.huffman_subsample_bits == 0) return h.groups[0];
    const int bits = h.huffman_subsample_bits;
    return h.groups[h.huffman_image[size_t(h.huffman_xsize) * size_t(y >> bits) +
                                    size_t(x >> bits)]];
  }

  // libwebp's DecodeImageData, not incremental: any read past the end is
  // an error, however many pixels were decoded
  bool DecodeImageData(Metadata& h, uint32_t* data, int width_, int height_) {
    int row = 0, col = 0;
    const int64_t total = int64_t(width_) * height_;
    int64_t pos = 0;
    const int len_code_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES;
    const int color_cache_limit = len_code_limit + h.color_cache_size;
    int64_t last_cached = 0;
    auto cache_upto = [&](int64_t end) {
      for (; last_cached < end; ++last_cached) {
        const uint32_t argb = data[size_t(last_cached)];
        h.color_cache[(argb * 0x1e35a7bdu) >> h.hash_shift] = argb;
      }
    };
    while (pos < total) {
      const HTreeGroup& g = GroupAt(h, col, row);
      int code;
      br.fill();
      code = ReadSymbol(g.htrees[GREEN].data(), br);
      if (br.is_end()) break;
      if (code < NUM_LITERAL_CODES) {
        const int red = ReadSymbol(g.htrees[RED].data(), br);
        br.fill();
        const int blue = ReadSymbol(g.htrees[BLUE].data(), br);
        const int alpha = ReadSymbol(g.htrees[ALPHA].data(), br);
        if (br.is_end()) break;
        data[size_t(pos)] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) |
                            (uint32_t(code) << 8) | uint32_t(blue);
      } else if (code < len_code_limit) {  // backward reference
        const int length = GetCopyDistance(code - NUM_LITERAL_CODES, br);
        const int dist_symbol = ReadSymbol(g.htrees[DIST].data(), br);
        br.fill();
        const int dist_code = GetCopyDistance(dist_symbol, br);
        const int dist = PlaneCodeToDistance(width_, dist_code);
        if (br.is_end()) break;
        if (pos < dist || total - pos < length) return false;
        for (int i = 0; i < length; ++i) {
          data[size_t(pos + i)] = data[size_t(pos + i - dist)];
        }
        pos += length;
        col += length;
        while (col >= width_) {
          col -= width_;
          ++row;
        }
        if (h.color_cache_size > 0) cache_upto(pos);
        continue;
      } else if (code < color_cache_limit) {  // colour cache
        cache_upto(pos);
        data[size_t(pos)] = h.color_cache[size_t(code - len_code_limit)];
      } else {
        return false;
      }
      ++pos;
      if (++col >= width_) {
        col = 0;
        ++row;
        if (h.color_cache_size > 0) cache_upto(pos);
      }
    }
    br.eos = br.is_end();
    return !br.eos;
  }

  // libwebp's DecodeAlphaData: green only, for an alpha stream whose one
  // transform is colour indexing and whose other codes have one symbol; a
  // read past the end is refused only before the last pixel
  bool DecodeAlphaData(uint8_t* data, int width_, int height_) {
    int row = 0, col = 0;
    const int64_t end = int64_t(width_) * height_;
    int64_t pos = 0;
    const int len_code_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES;
    bool ok = true;
    while (!br.eos && pos < end) {
      const HTreeGroup& g = GroupAt(hdr, col, row);
      br.fill();
      const int code = ReadSymbol(g.htrees[GREEN].data(), br);
      if (code < NUM_LITERAL_CODES) {
        data[size_t(pos)] = uint8_t(code);
        ++pos;
        if (++col >= width_) {
          col = 0;
          ++row;
        }
      } else if (code < len_code_limit) {
        const int length = GetCopyDistance(code - NUM_LITERAL_CODES, br);
        const int dist_symbol = ReadSymbol(g.htrees[DIST].data(), br);
        br.fill();
        const int dist_code = GetCopyDistance(dist_symbol, br);
        const int dist = PlaneCodeToDistance(width_, dist_code);
        if (pos >= dist && end - pos >= length) {
          for (int i = 0; i < length; ++i) {
            data[size_t(pos + i)] = data[size_t(pos + i - dist)];
          }
        } else {
          ok = false;
          break;
        }
        pos += length;
        col += length;
        while (col >= width_) {
          col -= width_;
          ++row;
        }
      } else {
        ok = false;
        break;
      }
      br.eos = br.is_end();
    }
    br.eos = br.is_end();
    return ok && !(br.eos && pos < end);
  }

  bool Is8bOptimizable() const {
    if (hdr.color_cache_size > 0) return false;
    for (const HTreeGroup& g : hdr.groups) {
      if (g.multi[RED] || g.multi[BLUE] || g.multi[ALPHA]) return false;
    }
    return true;
  }
};

// ---- inverse transforms over whole images

inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  const uint32_t alpha_and_green = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t red_and_blue = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (alpha_and_green & 0xff00ff00u) | (red_and_blue & 0x00ff00ffu);
}
inline uint32_t Average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
inline uint32_t Clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int AddSubtractComponentFull(int a, int b, int c) {
  return int(Clip255(uint32_t(a + b - c)));
}
inline uint32_t ClampedAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = AddSubtractComponentFull(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = AddSubtractComponentFull((c0 >> 16) & 0xff, (c1 >> 16) & 0xff,
                                         (c2 >> 16) & 0xff);
  const int g = AddSubtractComponentFull((c0 >> 8) & 0xff, (c1 >> 8) & 0xff,
                                         (c2 >> 8) & 0xff);
  const int b = AddSubtractComponentFull(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return (uint32_t(a) << 24) | (uint32_t(r) << 16) | (uint32_t(g) << 8) |
         uint32_t(b);
}
inline int AddSubtractComponentHalf(int a, int b) {
  return int(Clip255(uint32_t(a + (a - b) / 2)));
}
inline uint32_t ClampedAddSubtractHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = Average2(c0, c1);
  const int a = AddSubtractComponentHalf(ave >> 24, c2 >> 24);
  const int r = AddSubtractComponentHalf((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = AddSubtractComponentHalf((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = AddSubtractComponentHalf(ave & 0xff, c2 & 0xff);
  return (uint32_t(a) << 24) | (uint32_t(r) << 16) | (uint32_t(g) << 8) |
         uint32_t(b);
}
inline int Sub3(int a, int b, int c) {
  const int pb = b - c;
  const int pa = a - c;
  return std::abs(pb) - std::abs(pa);
}
inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb =
      Sub3(a >> 24, b >> 24, c >> 24) +
      Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
      Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
      Sub3(a & 0xff, b & 0xff, c & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}

// predictor `mode` for the pixel whose left neighbour is `left` and whose
// row above starts at `top` (top[-1] top-left, top[1] top-right)
inline uint32_t Predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return Average2(Average2(left, top[1]), top[0]);
    case 6: return Average2(left, top[-1]);
    case 7: return Average2(left, top[0]);
    case 8: return Average2(top[-1], top[0]);
    case 9: return Average2(top[0], top[1]);
    case 10: return Average2(Average2(left, top[-1]), Average2(top[0], top[1]));
    case 11: return Select(top[0], left, top[-1]);
    case 12: return ClampedAddSubtractFull(left, top[0], top[-1]);
    case 13: return ClampedAddSubtractHalf(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

void InversePredictor(const Transform& t, const uint32_t* in, uint32_t* out) {
  const int width = t.xsize;
  out[0] = AddPixels(in[0], 0xff000000u);
  for (int x = 1; x < width; ++x) out[x] = AddPixels(in[x], out[x - 1]);
  const int tiles_per_row = SubSampleSize(width, t.bits);
  for (int y = 1; y < t.ysize; ++y) {
    const uint32_t* src = in + size_t(y) * width;
    uint32_t* dst = out + size_t(y) * width;
    const uint32_t* up = dst - width;
    const uint32_t* modes =
        t.data.data() + size_t(y >> t.bits) * tiles_per_row;
    dst[0] = AddPixels(src[0], up[0]);
    for (int x = 1; x < width; ++x) {
      const int mode = int((modes[x >> t.bits] >> 8) & 0xf);
      dst[x] = AddPixels(src[x], Predict(mode, dst[x - 1], up + x));
    }
  }
}

inline int ColorTransformDelta(int8_t color_pred, int8_t color) {
  return (int(color_pred) * color) >> 5;
}

void InverseCrossColor(const Transform& t, uint32_t* data) {
  const int width = t.xsize;
  const int tiles_per_row = SubSampleSize(width, t.bits);
  for (int y = 0; y < t.ysize; ++y) {
    const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles_per_row;
    uint32_t* row = data + size_t(y) * width;
    for (int x = 0; x < width; ++x) {
      const uint32_t code = codes[x >> t.bits];
      const int8_t g2r = int8_t(code & 0xff);
      const int8_t g2b = int8_t((code >> 8) & 0xff);
      const int8_t r2b = int8_t((code >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int8_t green = int8_t(argb >> 8);
      int new_red = int((argb >> 16) & 0xff);
      int new_blue = int(argb & 0xff);
      new_red += ColorTransformDelta(g2r, green);
      new_red &= 0xff;
      new_blue += ColorTransformDelta(g2b, green);
      new_blue += ColorTransformDelta(r2b, int8_t(new_red));
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | (uint32_t(new_red) << 16) |
               uint32_t(new_blue);
    }
  }
}

void InverseSubtractGreen(uint32_t* data, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    const uint32_t argb = data[i];
    const uint32_t green = (argb >> 8) & 0xff;
    uint32_t red_blue = argb & 0x00ff00ffu;
    red_blue += (green << 16) | green;
    red_blue &= 0x00ff00ffu;
    data[i] = (argb & 0xff00ff00u) | red_blue;
  }
}

// the packed indices of a colour-indexed image (t.xsize wide once
// unpacked) to colours
void InverseColorIndexing(const Transform& t, const uint32_t* in,
                          uint32_t* out) {
  const int bits_per_pixel = 8 >> t.bits;
  const int count_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  const uint32_t* color_map = t.data.data();
  for (int y = 0; y < t.ysize; ++y) {
    uint32_t packed = 0;
    for (int x = 0; x < t.xsize; ++x) {
      if ((x & count_mask) == 0) packed = ((*in++) >> 8) & 0xff;
      *out++ = color_map[packed & bit_mask];
      packed >>= bits_per_pixel;
    }
  }
}

// applies the decoder's transforms, last read first; returns the pixels
std::vector<uint32_t> ApplyInverseTransforms(VP8LDecoder& dec,
                                             std::vector<uint32_t> pixels) {
  for (int n = dec.next_transform - 1; n >= 0; --n) {
    const Transform& t = dec.transforms[n];
    const size_t count = size_t(t.xsize) * size_t(t.ysize);
    switch (t.type) {
      case PREDICTOR_TRANSFORM: {
        std::vector<uint32_t> out(count);
        InversePredictor(t, pixels.data(), out.data());
        pixels.swap(out);
        break;
      }
      case CROSS_COLOR_TRANSFORM:
        InverseCrossColor(t, pixels.data());
        break;
      case SUBTRACT_GREEN_TRANSFORM:
        InverseSubtractGreen(pixels.data(), count);
        break;
      default: {
        std::vector<uint32_t> out(count);
        InverseColorIndexing(t, pixels.data(), out.data());
        pixels.swap(out);
        break;
      }
    }
  }
  return pixels;
}

// ------------------------------------------------------------------ ALPH

inline uint8_t GradientPredictor(uint8_t a, uint8_t b, uint8_t c) {
  const int g = a + b - c;
  return uint8_t((g & ~0xff) == 0 ? g : (g < 0) ? 0 : 255);
}

// libwebp's WebPUnfilters, row by row in place; `prev` is null for row 0
void Unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 0) return;
  if (filter == 1 || prev == nullptr) {  // horizontal (and every first row)
    uint8_t pred = (filter == 1 && prev != nullptr) ? prev[0] : 0;
    for (int i = 0; i < width; ++i) {
      row[i] = uint8_t(pred + row[i]);
      pred = row[i];
    }
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) row[i] = uint8_t(prev[i] + row[i]);
  } else {  // gradient
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      left = uint8_t(row[i] + GradientPredictor(left, top, top_left));
      top_left = top;
      row[i] = left;
    }
  }
}

// the alpha plane of an ALPH chunk's payload into `out` (width x height)
int DecodeAlpha(const uint8_t* data, size_t n, int width, int height,
                uint8_t* out) {
  if (n <= 1) return ERR_ALPH;
  const int method = data[0] & 3;
  const int filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3;
  const int rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || rsrv != 0) return ERR_ALPH;
  const size_t count = size_t(width) * size_t(height);
  if (method == 0) {
    if (n - 1 < count) return ERR_ALPH;
    std::memcpy(out, data + 1, count);
  } else {
    VP8LDecoder dec;
    dec.br.init(data + 1, n - 1);
    if (!dec.DecodeImageStream(width, height, true, nullptr)) return ERR_ALPH;
    const bool use_8b = dec.next_transform == 1 &&
                        dec.transforms[0].type == COLOR_INDEXING_TRANSFORM &&
                        dec.Is8bOptimizable();
    std::vector<uint32_t> pixels(size_t(dec.width) * size_t(dec.height), 0);
    if (use_8b) {
      std::vector<uint8_t> idx(pixels.size(), 0);
      if (!dec.DecodeAlphaData(idx.data(), dec.width, dec.height)) {
        return ERR_ALPH;
      }
      for (size_t i = 0; i < idx.size(); ++i) pixels[i] = uint32_t(idx[i]) << 8;
    } else if (!dec.DecodeImageData(dec.hdr, pixels.data(), dec.width,
                                    dec.height)) {
      return ERR_ALPH;
    }
    pixels = ApplyInverseTransforms(dec, std::move(pixels));
    for (size_t i = 0; i < count; ++i) out[i] = uint8_t(pixels[i] >> 8);
  }
  for (int y = 0; y < height; ++y) {
    Unfilter(filter, y ? out + size_t(y - 1) * width : nullptr,
             out + size_t(y) * width, width);
  }
  return 0;
}

}  // namespace

extern "C" {

// A VP8 key frame (`data`: the VP8 chunk's payload, padding included, as
// libwebp's animation decoder passes it) of width x height into `rgb`
// (3 bytes a pixel, rows `rgb_stride` bytes apart). `alpha` (its ALPH
// payload, or null) is decoded as libwebp decodes it, into `a` (rows
// `a_stride` bytes apart) when `a` is not null; a frame without alpha
// leaves `a` as it is.
int ecgmm_webp_vp8(const uint8_t* data, int64_t n, const uint8_t* alpha,
                   int64_t alpha_n, int width, int height, uint8_t* rgb,
                   int64_t rgb_stride, uint8_t* a, int64_t a_stride) {
  if (n < 10) return ERR_VP8_HEADER;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame || profile > 3 || !show) return ERR_VP8_HEADER;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) {
    return ERR_VP8_HEADER;
  }
  const int w = ((data[7] << 8) | data[6]) & 0x3fff;
  const int h = ((data[9] << 8) | data[8]) & 0x3fff;
  if (w != width || h != height || w == 0 || h == 0) return ERR_SIZE;
  if (partition_length > uint64_t(n) - 10) return ERR_VP8_PARTITIONS;
  VP8Decoder dec;
  dec.width = w;
  dec.height = h;
  dec.mb_w = (w + 15) >> 4;
  dec.mb_h = (h + 15) >> 4;
  const uint8_t* buf = data + 10;
  const size_t buf_size = size_t(n) - 10;
  dec.br.init(buf, partition_length);
  dec.br.bit(0x80);  // colour space
  dec.br.bit(0x80);  // clamping type
  if (!dec.ParseSegmentHeader() || !dec.ParseFilterHeader()) {
    return ERR_VP8_HEADER;
  }
  if (!dec.ParsePartitions(buf + partition_length,
                           buf_size - partition_length)) {
    return ERR_VP8_PARTITIONS;
  }
  dec.ParseQuant();
  dec.br.bit(0x80);  // update_proba, ignored for a key frame
  dec.ParseProba();
  std::vector<uint8_t> Y, U, V;
  const int rc = DecodeVP8Frame(dec, Y, U, V);
  if (rc != 0) return rc;
  if (alpha != nullptr) {
    std::vector<uint8_t> plane(size_t(w) * size_t(h));
    const int arc = DecodeAlpha(alpha, size_t(alpha_n), w, h, plane.data());
    if (arc != 0) return arc;
    if (a != nullptr) {
      for (int y = 0; y < h; ++y)
        std::memcpy(a + y * a_stride, plane.data() + size_t(y) * w, size_t(w));
    }
  }
  EmitFancyRGB(Y.data(), int64_t(dec.mb_w) * 16, U.data(), V.data(),
               int64_t(dec.mb_w) * 8, w, h, rgb, rgb_stride);
  return 0;
}

// A VP8L image (`data`: the VP8L chunk's payload, padding included) of
// width x height into `rgb` (and its alpha into `a` when not null).
int ecgmm_webp_vp8l(const uint8_t* data, int64_t n, int width, int height,
                    uint8_t* rgb, int64_t rgb_stride, uint8_t* a,
                    int64_t a_stride) {
  if (n < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return ERR_VP8L;
  VP8LDecoder dec;
  dec.br.init(data, size_t(n));
  if (dec.br.read(8) != 0x2f) return ERR_VP8L;
  const int w = int(dec.br.read(14)) + 1;
  const int h = int(dec.br.read(14)) + 1;
  dec.br.read(1);  // alpha hint
  if (dec.br.read(3) != 0 || dec.br.eos) return ERR_VP8L;
  if (w != width || h != height) return ERR_SIZE;
  if (!dec.DecodeImageStream(w, h, true, nullptr)) return ERR_VP8L;
  std::vector<uint32_t> pixels(size_t(dec.width) * size_t(dec.height), 0);
  if (!dec.DecodeImageData(dec.hdr, pixels.data(), dec.width, dec.height)) {
    return ERR_VP8L;
  }
  pixels = ApplyInverseTransforms(dec, std::move(pixels));
  for (int y = 0; y < h; ++y) {
    const uint32_t* src = pixels.data() + size_t(y) * w;
    uint8_t* dst = rgb + y * rgb_stride;
    for (int x = 0; x < w; ++x) {
      dst[3 * x + 0] = uint8_t(src[x] >> 16);
      dst[3 * x + 1] = uint8_t(src[x] >> 8);
      dst[3 * x + 2] = uint8_t(src[x]);
    }
    if (a != nullptr) {
      for (int x = 0; x < w; ++x) a[y * a_stride + x] = uint8_t(src[x] >> 24);
    }
  }
  return 0;
}

}  // extern "C"
