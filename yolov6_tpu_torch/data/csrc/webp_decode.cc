// WebP bitstream decoders for the WebP reader (data/webp.py): what
// libwebp's WebPDecodeBGRInto gives behind cv2.imread.
//
// - VP8L (lossless): the Huffman groups of the meta-Huffman image, the
//   colour cache, LZ77 with the distance map, and the four transforms
//   (predictor with its 14 modes, cross-colour, subtract-green, colour
//   indexing with pixel bundling), out as ARGB words.
// - VP8 (lossy) key frames, as RFC 6386 specifies them and libwebp decodes
//   them: the boolean decoder, segment and filter headers, token
//   partitions, intra modes (16x16, 4x4 with the key-frame contexts,
//   chroma), coefficient tokens with the default and updated
//   probabilities, the WHT and the IDCT, the simple and normal loop
//   filters; then libwebp's "fancy" upsampler (UpsampleBgrLinePair) and
//   its 14-bit YUV->BGR (VP8YUVToB/G/R) into BGR bytes.
//
// The constant tables (coefficient probabilities and their update
// probabilities, the key-frame 4x4 mode probabilities, the DC and AC
// quantiser steps, VP8L's distance map) are RFC 6386's and the WebP
// lossless specification's, in libwebp's order.
//
// C interface, safe to call from several threads at once: every function
// fills caller-owned memory, returns 0 on success and otherwise an error
// code with a message in `err`. Nothing aborts.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Code { OK = 0, UNSUPPORTED = 1, CORRUPT = 2, TRUNCATED = 3, INTERNAL = 4 };

struct Fail {
  int code;
  char msg[200];
};

[[noreturn]] void fail(int code, const char* fmt, long a = 0, long b = 0) {
  Fail f;
  f.code = code;
  std::snprintf(f.msg, sizeof(f.msg), fmt, a, b);
  throw f;
}

template <class F>
int run(char* err, int errlen, F body) {
  try {
    body();
    return OK;
  } catch (const Fail& f) {
    std::snprintf(err, errlen, "%s", f.msg);
    return f.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, errlen, "out of memory decoding the WebP");
    return INTERNAL;
  } catch (...) {
    std::snprintf(err, errlen, "internal error decoding the WebP");
    return INTERNAL;
  }
}

// ------------------------------------------------------------- tables

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

// ----------------------------------------------------------------- VP8L

struct LBits {  // LSB-first bit reader; zeros past the end, `eos` set
  const uint8_t* d;
  size_t n, pos = 0;  // pos in bits
  bool eos = false;
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = 0;
    size_t byte = pos >> 3;
    int sh = pos & 7;
    uint64_t acc = 0;
    for (int i = 0; i < 5; i++)
      if (byte + i < n) acc |= uint64_t(d[byte + i]) << (8 * i);
    v = static_cast<uint32_t>((acc >> sh) & ((uint64_t(1) << k) - 1));
    pos += k;
    if (pos > n * 8) eos = true;
    return v;
  }
  uint32_t peek(int k) const {
    size_t byte = pos >> 3;
    uint64_t acc = 0;
    for (int i = 0; i < 5; i++)
      if (byte + i < n) acc |= uint64_t(d[byte + i]) << (8 * i);
    return static_cast<uint32_t>((acc >> (pos & 7)) & ((uint64_t(1) << k) - 1));
  }
  void skip(int k) {
    pos += k;
    if (pos > n * 8) eos = true;
  }
};

// a canonical Huffman code, read MSB of the code first from the LSB-first
// stream; a code of one symbol takes no bits
struct Huffman {
  static constexpr int kRoot = 8;
  std::vector<int16_t> table;    // root lookup: symbol, or -1 for a longer code
  std::vector<uint8_t> tlen;     // its length
  std::vector<int> first_code, first_index, count;  // per length, for longer codes
  std::vector<int> sorted;
  int single = -1;
  int max_len = 0;

  void build(const std::vector<int>& lengths) {
    int n = static_cast<int>(lengths.size());
    count.assign(16, 0);
    int nonzero = 0, last = 0;
    for (int s = 0; s < n; s++)
      if (lengths[s]) {
        count[lengths[s]]++;
        nonzero++;
        last = s;
        if (lengths[s] > max_len) max_len = lengths[s];
      }
    if (nonzero == 0) fail(CORRUPT, "corrupt WebP lossless data: an empty Huffman code");
    if (nonzero == 1) {
      single = last;
      return;
    }
    // a complete code only (libwebp's BuildHuffmanTable)
    long space = 1;
    for (int l = 1; l < 16; l++) {
      space = space * 2 - count[l];
      if (space < 0) fail(CORRUPT, "corrupt WebP lossless data: an over-full Huffman code");
    }
    if (space != 0) fail(CORRUPT, "corrupt WebP lossless data: an incomplete Huffman code");
    first_code.assign(17, 0);
    first_index.assign(17, 0);
    int code = 0, idx = 0;
    for (int l = 1; l < 16; l++) {
      first_code[l] = code;
      first_index[l] = idx;
      code = (code + count[l]) << 1;
      idx += count[l];
    }
    sorted.assign(idx, 0);
    std::vector<int> next(16, 0);
    for (int l = 1; l < 16; l++) next[l] = first_index[l];
    for (int s = 0; s < n; s++)
      if (lengths[s]) sorted[next[lengths[s]]++] = s;
    table.assign(1 << kRoot, -1);
    tlen.assign(1 << kRoot, 0);
    // every code of up to kRoot bits fills the entries whose low bits are
    // its bits reversed
    std::vector<int> code_of(16, 0);
    for (int l = 1; l <= kRoot && l < 16; l++) {
      for (int k = 0; k < count[l]; k++) {
        int c = first_code[l] + k, rev = 0;
        for (int b = 0; b < l; b++) rev |= ((c >> b) & 1) << (l - 1 - b);
        for (int hi = 0; hi < (1 << (kRoot - l)); hi++) {
          table[rev | (hi << l)] = static_cast<int16_t>(sorted[first_index[l] + k]);
          tlen[rev | (hi << l)] = static_cast<uint8_t>(l);
        }
      }
    }
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    uint32_t p = br.peek(kRoot);
    if (table[p] >= 0) {
      br.skip(tlen[p]);
      return table[p];
    }
    int code = 0;
    for (int l = 1; l < 16; l++) {
      code = (code << 1) | static_cast<int>(br.read(1));
      int off = code - first_code[l];
      if (off >= 0 && off < count[l]) return sorted[first_index[l] + off];
    }
    fail(CORRUPT, "corrupt WebP lossless data: bad Huffman code");
  }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                                      14, 15};

Huffman read_huffman(LBits& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols
    int num = static_cast<int>(br.read(1)) + 1;
    int first_bits = br.read(1) ? 8 : 1;
    int s0 = static_cast<int>(br.read(first_bits));
    if (s0 >= alphabet) fail(CORRUPT, "corrupt WebP lossless data: bad simple code");
    lengths[s0] = 1;
    if (num == 2) {
      int s1 = static_cast<int>(br.read(8));
      if (s1 >= alphabet) fail(CORRUPT, "corrupt WebP lossless data: bad simple code");
      lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    int num = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num; i++) cl[kCodeLengthCodeOrder[i]] = static_cast<int>(br.read(3));
    Huffman lc;
    lc.build(cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(nbits));
      if (max_symbol > alphabet) fail(CORRUPT, "corrupt WebP lossless data: bad code lengths");
    }
    int sym = 0, prev = 8;
    while (sym < alphabet) {
      if (max_symbol-- == 0) break;
      if (br.eos) fail(TRUNCATED, "truncated WebP lossless data");
      int len = lc.read(br);
      if (len < 16) {
        lengths[sym++] = len;
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int slot = len - 16;
        int rep = static_cast<int>(br.read(kExtra[slot])) + kOffset[slot];
        if (sym + rep > alphabet) fail(CORRUPT, "corrupt WebP lossless data: bad code lengths");
        int v = len == 16 ? prev : 0;
        while (rep-- > 0) lengths[sym++] = v;
      }
    }
  }
  Huffman h;
  h.build(lengths);
  return h;
}

struct HGroup {
  Huffman h[5];  // green+lengths+cache, red, blue, alpha, distance
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int a) { return a < 0 ? 0 : (a > 255 ? 255 : a); }

inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff) - int((c >> s) & 0xff));
    out |= uint32_t(v) << s;
  }
  return out;
}

inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int x = int((a >> s) & 0xff), y = int((b >> s) & 0xff);
    out |= uint32_t(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}

inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int diff = 0;  // sum |L - TL| - sum |T - TL|
  for (int s = 0; s < 32; s += 8) {
    int a = int((t >> s) & 0xff), b = int((l >> s) & 0xff), c = int((tl >> s) & 0xff);
    diff += std::abs(b - c) - std::abs(a - c);
  }
  return diff <= 0 ? t : l;
}

uint32_t predict(int mode, const uint32_t* px, size_t i, int w) {
  const uint32_t L = px[i - 1], T = px[i - w], TL = px[i - w - 1], TR = px[i - w + 1];
  switch (mode) {
    case 0: return 0xff000000u;
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_add_sub_full(L, T, TL);
    case 13: return clamp_add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;
  }
}

struct Transform {
  int type = 0, bits = 0, xsize = 0;  // xsize: the width before the transform
  std::vector<uint32_t> data;         // sub-image, or the palette
};

struct VP8LDecoder {
  LBits br;

  static int div_round_up(int a, int bits) { return (a + (1 << bits) - 1) >> bits; }

  // one entropy-coded image of xsize x ysize, its transforms read first at
  // level 0
  std::vector<uint32_t> image(int xsize, int ysize, bool level0, std::vector<Transform>* tr) {
    if (level0) {
      int seen = 0;
      while (br.read(1)) {
        Transform t;
        t.type = static_cast<int>(br.read(2));
        if (seen & (1 << t.type)) fail(CORRUPT, "corrupt WebP lossless data: a repeated transform");
        seen |= 1 << t.type;
        t.xsize = xsize;
        if (t.type == 0 || t.type == 1) {
          t.bits = static_cast<int>(br.read(3)) + 2;
          t.data = image(div_round_up(xsize, t.bits), div_round_up(ysize, t.bits), false,
                         nullptr);
        } else if (t.type == 3) {
          int ncolors = static_cast<int>(br.read(8)) + 1;
          t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
          std::vector<uint32_t> pal = image(ncolors, 1, false, nullptr);
          for (int i = 1; i < ncolors; i++) pal[i] = add_pixels(pal[i], pal[i - 1]);
          t.data.assign(256, 0);
          std::copy(pal.begin(), pal.end(), t.data.begin());
          xsize = div_round_up(xsize, t.bits);
        }
        tr->push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = static_cast<int>(br.read(4));
      if (cache_bits < 1 || cache_bits > 11)
        fail(CORRUPT, "corrupt WebP lossless data: bad colour cache size");
    }
    int huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> huff_image;
    int ngroups = 1;
    if (level0 && br.read(1)) {
      huff_bits = static_cast<int>(br.read(3)) + 2;
      huff_xsize = div_round_up(xsize, huff_bits);
      huff_image = image(huff_xsize, div_round_up(ysize, huff_bits), false, nullptr);
      for (uint32_t& v : huff_image) {
        v = (v >> 8) & 0xffff;
        if (int(v) + 1 > ngroups) ngroups = int(v) + 1;
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<HGroup> groups(ngroups);
    const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    for (HGroup& g : groups)
      for (int k = 0; k < 5; k++) g.h[k] = read_huffman(br, alphabets[k]);
    if (br.eos) fail(TRUNCATED, "truncated WebP lossless data");

    const size_t total = size_t(xsize) * ysize;
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    size_t cached = 0;  // pixels up to here are in the cache
    auto to_cache = [&](size_t upto) {
      if (!cache_size) return;
      for (; cached < upto; cached++)
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    size_t i = 0;
    int x = 0, y = 0;
    const HGroup* g = &groups[0];
    const int mask = huff_bits ? (1 << huff_bits) - 1 : -1;
    while (i < total) {
      if (huff_bits && (x & mask) == 0)
        g = &groups[huff_image[size_t(y >> huff_bits) * huff_xsize + (x >> huff_bits)]];
      if (br.eos) fail(TRUNCATED, "truncated WebP lossless data");
      int code = g->h[0].read(br);
      if (code < 256) {
        uint32_t r = g->h[1].read(br), b = g->h[2].read(br), a = g->h[3].read(br);
        px[i++] = (a << 24) | (r << 16) | (uint32_t(code) << 8) | b;
        if (++x >= xsize) {
          x = 0;
          y++;
        }
      } else if (code < 256 + 24) {
        int len = copy_distance(code - 256);
        int dsym = g->h[4].read(br);
        int dcode = copy_distance(dsym);
        long dist = plane_to_distance(xsize, dcode);
        if (dist > long(i) || i + len > total)
          fail(CORRUPT, "corrupt WebP lossless data: a copy out of the image");
        for (int k = 0; k < len; k++, i++) px[i] = px[i - dist];
        x += len;
        while (x >= xsize) {
          x -= xsize;
          y++;
        }
        if (huff_bits && i < total)
          g = &groups[huff_image[size_t(y >> huff_bits) * huff_xsize + (x >> huff_bits)]];
      } else {
        int key = code - 280;
        if (key >= cache_size) fail(CORRUPT, "corrupt WebP lossless data: bad cache index");
        to_cache(i);
        px[i++] = cache[key];
        if (++x >= xsize) {
          x = 0;
          y++;
        }
      }
      to_cache(i);
    }
    return px;
  }

  int copy_distance(int sym) {
    if (sym < 4) return sym + 1;
    int extra = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  static long plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    int dc = kCodeToPlane[code - 1];
    int yoff = dc >> 4, xoff = 8 - (dc & 0xf);
    long d = long(yoff) * xsize + xoff;
    return d >= 1 ? d : 1;
  }
};

void inverse_transform(const Transform& t, int ysize, std::vector<uint32_t>& px) {
  const int w = t.xsize;
  if (t.type == 0) {  // predictor
    const int tiles = VP8LDecoder::div_round_up(w, t.bits);
    for (int y = 0; y < ysize; y++)
      for (int x = 0; x < w; x++) {
        size_t i = size_t(y) * w + x;
        uint32_t pred;
        if (y == 0) pred = x == 0 ? 0xff000000u : px[i - 1];
        else if (x == 0) pred = px[i - w];
        else
          pred = predict((t.data[size_t(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf, px.data(),
                         i, w);
        px[i] = add_pixels(px[i], pred);
      }
  } else if (t.type == 1) {  // cross-colour
    const int tiles = VP8LDecoder::div_round_up(w, t.bits);
    for (int y = 0; y < ysize; y++)
      for (int x = 0; x < w; x++) {
        uint32_t m = t.data[size_t(y >> t.bits) * tiles + (x >> t.bits)];
        int8_t g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff),
               r2b = static_cast<int8_t>((m >> 16) & 0xff);
        uint32_t& p = px[size_t(y) * w + x];
        int8_t green = static_cast<int8_t>(p >> 8);
        int r = (p >> 16) & 0xff, b = p & 0xff;
        r = (r + ((int(g2r) * green) >> 5)) & 0xff;
        b = (b + ((int(g2b) * green) >> 5)) & 0xff;
        b = (b + ((int(r2b) * int8_t(r)) >> 5)) & 0xff;
        p = (p & 0xff00ff00u) | (uint32_t(r) << 16) | uint32_t(b);
      }
  } else if (t.type == 2) {  // subtract green
    for (uint32_t& p : px) {
      uint32_t g = (p >> 8) & 0xff;
      uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else {  // colour indexing, the packed width widened back to w
    const int packed_w = VP8LDecoder::div_round_up(w, t.bits);
    std::vector<uint32_t> out(size_t(w) * ysize);
    const int bpp = 8 >> t.bits, per = 1 << t.bits, mask = (1 << bpp) - 1;
    for (int y = 0; y < ysize; y++)
      for (int x = 0; x < w; x++) {
        uint32_t packed = px[size_t(y) * packed_w + (x >> t.bits)];
        int idx = (packed >> (8 + (x & (per - 1)) * bpp)) & mask;
        out[size_t(y) * w + x] = t.data[idx];
      }
    px.swap(out);
  }
}

void vp8l_decode(const uint8_t* d, size_t n, int want_w, int want_h, uint32_t* argb) {
  if (n < 5 || d[0] != 0x2f) fail(CORRUPT, "corrupt WebP lossless data: no VP8L signature");
  VP8LDecoder dec{LBits{d + 1, n - 1}};
  int w = static_cast<int>(dec.br.read(14)) + 1, h = static_cast<int>(dec.br.read(14)) + 1;
  dec.br.read(1);  // alpha_is_used: a hint only
  if (dec.br.read(3) != 0) fail(UNSUPPORTED, "WebP lossless version other than 0");
  if (w != want_w || h != want_h)
    fail(INTERNAL, "VP8L image is %ldx%ld, not the caller's size", w, h);
  std::vector<Transform> tr;
  std::vector<uint32_t> px = dec.image(w, h, true, &tr);
  for (size_t k = tr.size(); k-- > 0;) inverse_transform(tr[k], h, px);
  std::memcpy(argb, px.data(), px.size() * sizeof(uint32_t));
}

// ------------------------------------------------------------------ VP8

struct BoolDecoder {  // RFC 6386 section 7
  const uint8_t* d;
  size_t n, pos = 0;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  void init(const uint8_t* data, size_t size) {
    d = data;
    n = size;
    pos = 0;
    value = (uint32_t(byte()) << 8);
    value |= byte();
    range = 255;
    bit_count = 0;
  }
  uint32_t byte() { return pos < n ? d[pos++] : (pos++, 0u); }
  int bit(int prob) {
    uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    uint32_t big = split << 8;
    int ret;
    if (value >= big) {
      ret = 1;
      range -= split;
      value -= big;
    } else {
      ret = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= byte();
      }
    }
    return ret;
  }
  int get(int bits) {
    int v = 0;
    while (bits-- > 0) v |= bit(0x80) << bits;
    return v;
  }
  int get_signed(int bits) {
    int v = get(bits);
    return bit(0x80) ? -v : v;
  }
};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
const int8_t kYModesIntra4[18] = {-B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6,
                                  -B_HE_PRED, 5, -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7,
                                  -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct MBData {
  int16_t coeffs[384];
  bool is_i4x4 = false, skip = false;
  uint8_t imodes[16];
  uint8_t uvmode = 0;
  int segment = 0;
  bool nonzero = false;  // any coefficient (libwebp's non_zero_y | non_zero_uv)
};

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

// the transforms of RFC 6386 section 14, libwebp's TransformOne and
// TransformWHT, adding into `dst` (stride `bps`)
void idct_add(const int16_t* in, uint8_t* dst, int bps) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16], *tmp = C;
  for (int i = 0; i < 4; i++) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += bps;
  }
}

void wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction on a work buffer of stride kBps (libwebp's layout)

constexpr int kBps = 32;
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
#define DST(x, y) dst[(x) + (y) * kBps]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  for (int y = 0; y < size; y++)
    for (int x = 0; x < size; x++)
      dst[y * kBps + x] = clip8(top[x] + dst[y * kBps - 1] - top[-1]);
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBps;
  const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * kBps];
      dc >>= 3;
      for (int y = 0; y < 4; y++) std::memset(dst + y * kBps, dc, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t v[4] = {uint8_t(avg3(X, A, B)), uint8_t(avg3(A, B, C)), uint8_t(avg3(B, C, D)),
                            uint8_t(avg3(C, D, E))};
      for (int y = 0; y < 4; y++) std::memcpy(dst + y * kBps, v, 4);
      break;
    }
    case B_HE_PRED: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; y++) std::memset(dst + y * kBps, v[y], 4);
      break;
    }
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
  }
}
#undef DST

// 16x16 (size 16) and chroma (size 8): DC with or without its top and left
void pred_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const uint8_t* top = dst - kBps;
  if (mode == B_DC_PRED) {
    int shift = size == 16 ? 4 : 3;
    int dc;
    if (has_top && has_left) {
      dc = size;
      for (int i = 0; i < size; i++) dc += top[i] + dst[-1 + i * kBps];
      dc >>= shift + 1;
    } else if (has_left) {
      dc = size >> 1;
      for (int i = 0; i < size; i++) dc += dst[-1 + i * kBps];
      dc >>= shift;
    } else if (has_top) {
      dc = size >> 1;
      for (int i = 0; i < size; i++) dc += top[i];
      dc >>= shift;
    } else {
      dc = 0x80;
    }
    for (int y = 0; y < size; y++) std::memset(dst + y * kBps, dc, size);
  } else if (mode == B_TM_PRED) {
    true_motion(dst, size);
  } else if (mode == B_VE_PRED) {
    for (int y = 0; y < size; y++) std::memcpy(dst + y * kBps, top, size);
  } else {  // B_HE_PRED
    for (int y = 0; y < size; y++) std::memset(dst + y * kBps, dst[y * kBps - 1], size);
  }
}

// ---- loop filters (libwebp's dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; i++, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; i++, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (mb_edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int segment_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  // the planes, whole macroblocks
  std::vector<uint8_t> y, u, v;
  int ystride = 0, uvstride = 0;

  void headers(const uint8_t* d, size_t n) {
    if (n < 10) fail(TRUNCATED, "truncated WebP VP8 frame header");
    const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
    const bool key = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const uint32_t part0 = bits >> 5;
    if (!key) fail(UNSUPPORTED, "WebP VP8 frame that is not a key frame");
    if (profile > 3) fail(CORRUPT, "corrupt WebP VP8 data: bad profile");
    if (!((bits >> 4) & 1)) fail(UNSUPPORTED, "WebP VP8 frame that is not shown");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
      fail(CORRUPT, "corrupt WebP VP8 data: bad start code");
    width = (d[6] | (d[7] << 8)) & 0x3fff;
    height = (d[8] | (d[9] << 8)) & 0x3fff;
    d += 10;
    n -= 10;
    if (part0 > n) fail(TRUNCATED, "truncated WebP VP8 data: the first partition");
    br.init(d, part0);
    const uint8_t* rest = d + part0;
    size_t rest_n = n - part0;
    br.get(1);  // colour space
    br.get(1);  // clamping type
    use_segment = br.get(1);
    if (use_segment) {
      update_map = br.get(1);
      if (br.get(1)) {
        absolute_delta = br.get(1);
        for (int s = 0; s < 4; s++) quantizer[s] = br.get(1) ? br.get_signed(7) : 0;
        for (int s = 0; s < 4; s++) filter_strength[s] = br.get(1) ? br.get_signed(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; s++) segment_probs[s] = br.get(1) ? br.get(8) : 255;
    }
    simple = br.get(1);
    level = br.get(6);
    sharpness = br.get(3);
    use_lf_delta = br.get(1);
    if (use_lf_delta && br.get(1)) {
      for (int i = 0; i < 4; i++)
        if (br.get(1)) ref_lf_delta[i] = br.get_signed(6);
      for (int i = 0; i < 4; i++)
        if (br.get(1)) mode_lf_delta[i] = br.get_signed(6);
    }
    filter_type = level == 0 ? 0 : (simple ? 1 : 2);
    // token partitions
    const int nparts = 1 << br.get(2);
    const size_t sizes_n = 3 * size_t(nparts - 1);
    if (rest_n < sizes_n) fail(TRUNCATED, "truncated WebP VP8 data: the partition sizes");
    const uint8_t* part = rest + sizes_n;
    size_t left = rest_n - sizes_n;
    parts.resize(nparts);
    for (int p = 0; p < nparts; p++) {
      size_t psize = left;
      if (p < nparts - 1) {
        const uint8_t* s = rest + 3 * p;
        psize = s[0] | (s[1] << 8) | (s[2] << 16);
        if (psize > left) psize = left;
      }
      parts[p].init(part, psize);
      part += psize;
      left -= psize;
    }
    // quantisers
    const int base_q0 = br.get(7);
    const int dqy1_dc = br.get(1) ? br.get_signed(4) : 0;
    const int dqy2_dc = br.get(1) ? br.get_signed(4) : 0;
    const int dqy2_ac = br.get(1) ? br.get_signed(4) : 0;
    const int dquv_dc = br.get(1) ? br.get_signed(4) : 0;
    const int dquv_ac = br.get(1) ? br.get_signed(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : (v > m ? m : v); };
    for (int s = 0; s < 4; s++) {
      int q;
      if (use_segment) {
        q = quantizer[s] + (absolute_delta ? 0 : base_q0);
      } else if (s > 0) {
        dqm[s] = dqm[0];
        continue;
      } else {
        q = base_q0;
      }
      QuantMatrix& m = dqm[s];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.get(1);  // update_proba: ignored on a key frame
    for (int t = 0; t < 4; t++)
      for (int b = 0; b < 8; b++)
        for (int c = 0; c < 3; c++)
          for (int p = 0; p < 11; p++)
            proba[t][b][c][p] = static_cast<uint8_t>(
                br.bit(kCoeffsUpdateProba[t][b][c][p]) ? br.get(8) : kCoeffsProba0[t][b][c][p]);
    use_skip = br.get(1);
    if (use_skip) skip_p = br.get(8);
  }

  void filter_strengths() {
    for (int s = 0; s < 4; s++) {
      int base = use_segment ? filter_strength[s] + (absolute_delta ? 0 : level) : level;
      for (int i4 = 0; i4 <= 1; i4++) {
        FInfo& f = fstrengths[s][i4];
        int lv = base;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : (lv > 63 ? 63 : lv);
        if (lv > 0) {
          int il = lv;
          if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * lv + il;
          f.hev = lv >= 40 ? 2 : (lv >= 15 ? 1 : 0);
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }

  // the tokens of one 4x4 block from position n: the index past the last
  // nonzero coefficient
  static int get_coeffs(BoolDecoder& b, const uint8_t (*bands)[3][11], int ctx, const int* dq,
                        int n, int16_t* out) {
    const uint8_t* p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b.bit(p[0])) return n;
      while (!b.bit(p[1])) {
        p = bands[kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = bands[kBands[n + 1]];
      int v;
      if (!b.bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        if (!b.bit(p[3])) {
          if (!b.bit(p[4])) v = 2;
          else v = 3 + b.bit(p[5]);
        } else if (!b.bit(p[6])) {
          if (!b.bit(p[7])) {
            v = 5 + b.bit(159);
          } else {
            v = 7 + 2 * b.bit(165);
            v += b.bit(145);
          }
        } else {
          const int bit1 = b.bit(p[8]);
          const int bit0 = b.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = p_ctx[2];
      }
      out[kZigzag[n]] = static_cast<int16_t>((b.bit(0x80) ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  void decode(uint8_t* bgr) {
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    y.assign(size_t(ystride) * mb_h * 16, 0);
    u.assign(size_t(uvstride) * mb_h * 8, 0);
    v.assign(size_t(uvstride) * mb_h * 8, 0);
    filter_strengths();
    std::vector<uint8_t> intra_t(size_t(mb_w) * 4, B_DC_PRED);
    std::vector<uint8_t> top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
    std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
    // unfiltered top samples of each macroblock column, for prediction
    std::vector<uint8_t> top_y(static_cast<size_t>(ystride), 0);
    std::vector<uint8_t> top_u(static_cast<size_t>(uvstride), 0), top_v(top_u);
    // the work buffer: Y with its left column, top row and top-right, then U, V
    uint8_t work[kBps * 17 + kBps * 9 * 2];
    uint8_t* const ydst = work + kBps + 8;
    uint8_t* const udst = work + kBps * 17 + kBps + 8;
    uint8_t* const vdst = work + kBps * 17 + kBps * 9 + kBps + 8;
    MBData mb;
    for (int mby = 0; mby < mb_h; mby++) {
      BoolDecoder& tb = parts[mby & (parts.size() - 1)];
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int j = 0; j < 16; j++) ydst[j * kBps - 1] = 129;
      for (int j = 0; j < 8; j++) udst[j * kBps - 1] = vdst[j * kBps - 1] = 129;
      if (mby > 0) {
        ydst[-1 - kBps] = udst[-1 - kBps] = vdst[-1 - kBps] = 129;
      } else {
        std::memset(ydst - kBps - 1, 127, 16 + 4 + 1);
        std::memset(udst - kBps - 1, 127, 8 + 1);
        std::memset(vdst - kBps - 1, 127, 8 + 1);
      }
      for (int mbx = 0; mbx < mb_w; mbx++) {
        // modes, from the first partition
        uint8_t* top = intra_t.data() + 4 * mbx;
        mb.segment = update_map ? (!br.bit(segment_probs[0]) ? br.bit(segment_probs[1])
                                                              : br.bit(segment_probs[2]) + 2)
                                : 0;
        mb.skip = use_skip ? br.bit(skip_p) : false;
        mb.is_i4x4 = !br.bit(145);
        if (!mb.is_i4x4) {
          const int ymode = br.bit(156) ? (br.bit(128) ? B_TM_PRED : B_HE_PRED)
                                        : (br.bit(163) ? B_VE_PRED : B_DC_PRED);
          mb.imodes[0] = static_cast<uint8_t>(ymode);
          std::memset(top, ymode, 4);
          std::memset(intra_l, ymode, 4);
        } else {
          uint8_t* modes = mb.imodes;
          for (int yy = 0; yy < 4; yy++) {
            int ymode = intra_l[yy];
            for (int xx = 0; xx < 4; xx++) {
              const uint8_t* prob = kBModesProba[top[xx]][ymode];
              int i = kYModesIntra4[br.bit(prob[0])];
              while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
              ymode = -i;
              top[xx] = static_cast<uint8_t>(ymode);
            }
            std::memcpy(modes, top, 4);
            modes += 4;
            intra_l[yy] = static_cast<uint8_t>(ymode);
          }
        }
        mb.uvmode = !br.bit(142) ? B_DC_PRED
                                 : !br.bit(114) ? B_VE_PRED : br.bit(183) ? B_TM_PRED : B_HE_PRED;
        // residuals, from the token partition
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
        bool skip = mb.skip;
        if (!skip) {
          skip = !residuals(tb, mb, top_nz[mbx], top_nz_dc[mbx], left_nz, left_nz_dc);
        } else {
          left_nz = top_nz[mbx] = 0;
          if (!mb.is_i4x4) left_nz_dc = top_nz_dc[mbx] = 0;
        }
        if (filter_type > 0) {
          FInfo f = fstrengths[mb.segment][mb.is_i4x4];
          f.inner = f.inner || !skip;
          finfo[size_t(mby) * mb_w + mbx] = f;
        }
        reconstruct(mb, mbx, mby, ydst, udst, vdst, top_y, top_u, top_v);
      }
    }
    if (filter_type > 0)
      for (int mby = 0; mby < mb_h; mby++)
        for (int mbx = 0; mbx < mb_w; mbx++) filter_mb(finfo[size_t(mby) * mb_w + mbx], mbx, mby);
    to_bgr(bgr);
  }

  // libwebp's ParseResiduals: true when any coefficient is nonzero
  bool residuals(BoolDecoder& tb, MBData& mb, uint8_t& tnz_mb, uint8_t& tnz_dc, uint8_t& lnz_mb,
                 uint8_t& lnz_dc) {
    const QuantMatrix& q = dqm[mb.segment];
    int16_t* dst = mb.coeffs;
    bool any = false;
    int first;
    const uint8_t(*ac_proba)[3][11];
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = tnz_dc + lnz_dc;
      const int nz = get_coeffs(tb, proba[1], ctx, q.y2, 0, dc);
      tnz_dc = lnz_dc = nz > 0;
      if (nz > 1) {
        wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_proba = proba[0];
    } else {
      first = 0;
      ac_proba = proba[3];
    }
    uint8_t tnz = tnz_mb & 0x0f, lnz = lnz_mb & 0x0f;
    for (int yy = 0; yy < 4; yy++) {
      int l = lnz & 1;
      for (int xx = 0; xx < 4; xx++) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tb, ac_proba, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        if (nz > 1 || dst[0] != 0) any = true;
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    }
    uint8_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t t2 = tnz_mb >> (4 + ch), l2 = lnz_mb >> (4 + ch);
      for (int yy = 0; yy < 2; yy++) {
        int l = l2 & 1;
        for (int xx = 0; xx < 2; xx++) {
          const int ctx = l + (t2 & 1);
          const int nz = get_coeffs(tb, proba[2], ctx, q.uv, 0, dst);
          l = nz > 0;
          t2 = (t2 >> 1) | (l << 3);
          if (nz > 1 || dst[0] != 0) any = true;
          dst += 16;
        }
        t2 >>= 2;
        l2 = (l2 >> 1) | (l << 5);
      }
      out_t |= static_cast<uint8_t>((t2 << 4) << ch);
      out_l |= static_cast<uint8_t>((l2 & 0xf0) << ch);
    }
    tnz_mb = out_t;
    lnz_mb = out_l;
    return any;
  }

  void reconstruct(const MBData& mb, int mbx, int mby, uint8_t* ydst, uint8_t* udst,
                   uint8_t* vdst, std::vector<uint8_t>& top_y, std::vector<uint8_t>& top_u,
                   std::vector<uint8_t>& top_v) {
    if (mbx > 0) {  // the left samples from the macroblock before
      for (int j = -1; j < 16; j++) std::memcpy(ydst + j * kBps - 4, ydst + j * kBps + 12, 4);
      for (int j = -1; j < 8; j++) {
        std::memcpy(udst + j * kBps - 4, udst + j * kBps + 4, 4);
        std::memcpy(vdst + j * kBps - 4, vdst + j * kBps + 4, 4);
      }
    }
    if (mby > 0) {
      std::memcpy(ydst - kBps, top_y.data() + 16 * mbx, 16);
      std::memcpy(udst - kBps, top_u.data() + 8 * mbx, 8);
      std::memcpy(vdst - kBps, top_v.data() + 8 * mbx, 8);
    }
    const int16_t* coeffs = mb.coeffs;
    if (mb.is_i4x4) {
      uint8_t* top_right = ydst - kBps + 16;
      if (mby > 0) {
        if (mbx >= mb_w - 1) std::memset(top_right, top_y[16 * mbx + 15], 4);
        else std::memcpy(top_right, top_y.data() + 16 * (mbx + 1), 4);
      }
      for (int r = 1; r <= 3; r++) std::memcpy(top_right + r * 4 * kBps, top_right, 4);
      for (int n = 0; n < 16; n++) {
        uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * kBps;
        pred4(dst, mb.imodes[n]);
        idct_add(coeffs + n * 16, dst, kBps);
      }
    } else {
      pred_block(ydst, 16, mb.imodes[0], mby > 0, mbx > 0);
      for (int n = 0; n < 16; n++)
        idct_add(coeffs + n * 16, ydst + (n & 3) * 4 + (n >> 2) * 4 * kBps, kBps);
    }
    pred_block(udst, 8, mb.uvmode, mby > 0, mbx > 0);
    pred_block(vdst, 8, mb.uvmode, mby > 0, mbx > 0);
    for (int n = 0; n < 4; n++) {
      idct_add(coeffs + 256 + n * 16, udst + (n & 1) * 4 + (n >> 1) * 4 * kBps, kBps);
      idct_add(coeffs + 320 + n * 16, vdst + (n & 1) * 4 + (n >> 1) * 4 * kBps, kBps);
    }
    if (mby < mb_h - 1) {
      std::memcpy(top_y.data() + 16 * mbx, ydst + 15 * kBps, 16);
      std::memcpy(top_u.data() + 8 * mbx, udst + 7 * kBps, 8);
      std::memcpy(top_v.data() + 8 * mbx, vdst + 7 * kBps, 8);
    }
    for (int j = 0; j < 16; j++)
      std::memcpy(y.data() + size_t(mby * 16 + j) * ystride + mbx * 16, ydst + j * kBps, 16);
    for (int j = 0; j < 8; j++) {
      std::memcpy(u.data() + size_t(mby * 8 + j) * uvstride + mbx * 8, udst + j * kBps, 8);
      std::memcpy(v.data() + size_t(mby * 8 + j) * uvstride + mbx * 8, vdst + j * kBps, 8);
    }
  }

  void filter_mb(const FInfo& f, int mbx, int mby) {
    if (f.limit == 0) return;
    uint8_t* yp = y.data() + size_t(mby) * 16 * ystride + mbx * 16;
    const int limit = f.limit, il = f.ilevel, hv = f.hev;
    if (filter_type == 1) {
      if (mbx > 0) simple_filter(yp, 1, ystride, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple_filter(yp + 4 * k, 1, ystride, 16, limit);
      if (mby > 0) simple_filter(yp, ystride, 1, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple_filter(yp + 4 * k * ystride, ystride, 1, 16, limit);
      return;
    }
    uint8_t* up = u.data() + size_t(mby) * 8 * uvstride + mbx * 8;
    uint8_t* vp = v.data() + size_t(mby) * 8 * uvstride + mbx * 8;
    const int ys = ystride, us = uvstride;
    if (mbx > 0) {
      filter_loop(yp, 1, ys, 16, limit + 4, il, hv, true);
      filter_loop(up, 1, us, 8, limit + 4, il, hv, true);
      filter_loop(vp, 1, us, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++) filter_loop(yp + 4 * k, 1, ys, 16, limit, il, hv, false);
      filter_loop(up + 4, 1, us, 8, limit, il, hv, false);
      filter_loop(vp + 4, 1, us, 8, limit, il, hv, false);
    }
    if (mby > 0) {
      filter_loop(yp, ys, 1, 16, limit + 4, il, hv, true);
      filter_loop(up, us, 1, 8, limit + 4, il, hv, true);
      filter_loop(vp, us, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++) filter_loop(yp + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      filter_loop(up + 4 * us, us, 1, 8, limit, il, hv, false);
      filter_loop(vp + 4 * us, us, 1, 8, limit, il, hv, false);
    }
  }

  // libwebp's yuv.h: 14-bit fixed point, then >> 6 with saturation
  static inline int mult_hi(int v, int c) { return (v * c) >> 8; }
  static inline uint8_t yuv_clip(int v) {
    return ((v & ~16383) == 0) ? static_cast<uint8_t>(v >> 6) : (v < 0 ? 0 : 255);
  }
  static inline void yuv_to_bgr(int yy, int uu, int vv, uint8_t* out) {
    out[0] = yuv_clip(mult_hi(yy, 19077) + mult_hi(uu, 33050) - 17685);
    out[1] = yuv_clip(mult_hi(yy, 19077) - mult_hi(uu, 6419) - mult_hi(vv, 13320) + 8708);
    out[2] = yuv_clip(mult_hi(yy, 19077) + mult_hi(vv, 26149) - 14234);
  }

  // UpsampleBgrLinePair: two luma rows against two chroma rows
  void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                     const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                     uint8_t* top_dst, uint8_t* bottom_dst, int len) const {
    auto load = [](const uint8_t* uu, const uint8_t* vv, int x) {
      return uint32_t(uu[x]) | (uint32_t(vv[x]) << 16);
    };
    const int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = load(top_u, top_v, 0), l_uv = load(cur_u, cur_v, 0);
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_bgr(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_bgr(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pair; x++) {
      const uint32_t t_uv = load(top_u, top_v, x), uv = load(cur_u, cur_v, x);
      const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
      const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
      const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
      {
        const uint32_t uv0 = (diag_12 + tl_uv) >> 1, uv1 = (diag_03 + t_uv) >> 1;
        yuv_to_bgr(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, top_dst + (2 * x - 1) * 3);
        yuv_to_bgr(top_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, top_dst + (2 * x) * 3);
      }
      if (bottom_y) {
        const uint32_t uv0 = (diag_03 + l_uv) >> 1, uv1 = (diag_12 + uv) >> 1;
        yuv_to_bgr(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff,
                   bottom_dst + (2 * x - 1) * 3);
        yuv_to_bgr(bottom_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, bottom_dst + (2 * x) * 3);
      }
      tl_uv = t_uv;
      l_uv = uv;
    }
    if (!(len & 1)) {
      {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_bgr(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
      }
      if (bottom_y) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_bgr(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
      }
    }
  }

  // EmitFancyRGB over the whole picture
  void to_bgr(uint8_t* out) const {
    const size_t row = size_t(width) * 3;
    auto Y = [&](int r) { return y.data() + size_t(r) * ystride; };
    auto U = [&](int r) { return u.data() + size_t(r) * uvstride; };
    auto V = [&](int r) { return v.data() + size_t(r) * uvstride; };
    upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), out, nullptr, width);
    int r = 1;
    for (; r + 1 < height; r += 2) {
      const int k = (r + 1) >> 1;
      upsample_pair(Y(r), Y(r + 1), U(k - 1), V(k - 1), U(k), V(k), out + r * row,
                    out + (r + 1) * row, width);
    }
    if (!(height & 1) && height > 1) {
      const int k = (height >> 1) - 1;
      upsample_pair(Y(height - 1), nullptr, U(k), V(k), U(k), V(k), out + (height - 1) * row,
                    nullptr, width);
    }
  }
};

}  // namespace

extern "C" {

// Width and height of a VP8L bitstream (`data` from its 0x2f signature).
int yolov6_webp_vp8l_size(const uint8_t* data, size_t size, int* width, int* height, char* err,
                          int errlen) {
  return run(err, errlen, [&] {
    if (size < 5 || data[0] != 0x2f) fail(CORRUPT, "corrupt WebP lossless data: no signature");
    LBits b{data + 1, size - 1};
    *width = static_cast<int>(b.read(14)) + 1;
    *height = static_cast<int>(b.read(14)) + 1;
  });
}

// Decode a VP8L bitstream into `argb`, width x height words 0xAARRGGBB.
int yolov6_webp_vp8l_decode(const uint8_t* data, size_t size, int width, int height,
                            uint32_t* argb, char* err, int errlen) {
  return run(err, errlen, [&] { vp8l_decode(data, size, width, height, argb); });
}

// Width and height of a VP8 key frame (`data` from its frame tag).
int yolov6_webp_vp8_size(const uint8_t* data, size_t size, int* width, int* height, char* err,
                         int errlen) {
  return run(err, errlen, [&] {
    if (size < 10 || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
      fail(CORRUPT, "corrupt WebP VP8 data: bad frame header");
    *width = (data[6] | (data[7] << 8)) & 0x3fff;
    *height = (data[8] | (data[9] << 8)) & 0x3fff;
  });
}

// Decode a VP8 key frame into `bgr`, height x width x 3 bytes, as
// WebPDecodeBGRInto writes them.
int yolov6_webp_vp8_decode(const uint8_t* data, size_t size, int width, int height, uint8_t* bgr,
                           char* err, int errlen) {
  return run(err, errlen, [&] {
    VP8Decoder dec;
    dec.headers(data, size);
    if (dec.width != width || dec.height != height)
      fail(INTERNAL, "VP8 frame is %ldx%ld, not the caller's size", dec.width, dec.height);
    if (width == 0 || height == 0) fail(CORRUPT, "corrupt WebP VP8 data: an empty frame");
    dec.decode(bgr);
  });
}

}  // extern "C"
