// JPEG decoder that returns exactly what cv2.imread returns for the files it
// accepts: libjpeg-turbo's default decompression (jdhuff.c's and jdphuff.c's
// Huffman decoding, the accurate integer IDCT as its x86-64 SIMD computes
// it, jdsample.c's "fancy" upsampling, jdcolor.c's fixed-point YCbCr->RGB),
// written out as BGR, with the Exif orientation read as OpenCV reads it (the
// first APP1 segment). Written from ITU-T T.81 and the integer pipeline of
// those files. It also decodes as libjpeg does at scale_denom 2, 4 and 8 to
// RGB (jidctred.c's reduced IDCTs; the JAX package's train-path read), and
// block-smooths a progressive image whose first AC coefficients are not all
// final (jdcoefct.c decompress_smooth_data, as libjpeg-turbo 3 does it).
//
// Accepted: SOF0/SOF1 (sequential) and SOF2 (progressive: spectral
// selection and successive approximation), Huffman-coded, at 8-bit precision
// with 1, 3 or 4 components, interleaved and non-interleaved scans, DRI with
// RST0-7. Every scan decodes into a whole-image coefficient buffer, which the
// IDCT reads once at the end.
//
// A stream that ends early decodes as libjpeg-turbo decodes it behind
// OpenCV's file source, which inserts a fake EOI at the end of the data: the
// MCU that runs out finishes on zero bits, every later MCU of the scan keeps
// zero coefficients (128 grey through the IDCT, or the earlier scans'
// coefficients, smoothed, in a progressive file), and the image is returned
// with the `truncated` flag set. A file that ends before its first scan, or
// inside a table or SOS segment after it, gives an error. The rest
// (lossless, hierarchical, arithmetic coding, 12-bit) and corrupt streams
// give an error. Four components are CMYK, or YCCK under Adobe transform 2
// (jdcolor.c ycck_cmyk_convert), turned into BGR as OpenCV turns libjpeg's
// CMYK (Adobe's inverted CMYK, icvCvt_CMYK2BGR_8u_C4C3R). The caller may
// force the colour space as libtiff does for a JPEG-compressed TIFF
// (yolov6_jpeg_decode_as): YCbCr (YCCK) or none (RGB/CMYK as stored).
//
// C interface, safe to call from several threads at once: every function
// takes a byte buffer and fills caller-owned memory, returns 0 on success
// and otherwise an error code with a message in `err`. Nothing aborts.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <vector>

#include "simple_idct.h"

namespace {

// NOT_RGB: a file libjpeg reads but does not convert to RGB (CMYK, YCCK),
// which the train path's caller reads another way
enum Code { OK = 0, UNSUPPORTED = 1, CORRUPT = 2, TRUNCATED = 3, INTERNAL = 4, NOT_RGB = 5 };

struct Fail {
  int code;
  char msg[200];
};

[[noreturn]] void fail(int code, const char* fmt, int a = 0, int b = 0) {
  Fail f;
  f.code = code;
  std::snprintf(f.msg, sizeof(f.msg), fmt, a, b);
  throw f;
}

// zigzag index -> natural (row-major) index; the 16 trailing entries catch a
// run past coefficient 63 in a corrupt stream, as jpeg_natural_order's do
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------ Huffman

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // vals index = code + valoffset[length]
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer code
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_huff(Huff& t, const uint8_t* bits, const uint8_t* vals, int nvals, bool dc) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail(CORRUPT, "corrupt JPEG data: bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += bits[l];
      t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 1; i <= bits[l]; i++, p++) {
      int look = static_cast<int>(huffcode[p]) << (kLookBits - l);
      for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--)
        t.look[look++] = static_cast<uint16_t>((l << 8) | vals[p]);
    }
  }
  std::memcpy(t.vals, vals, nvals);
  if (dc)
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) fail(CORRUPT, "corrupt JPEG data: bad Huffman table");
}

// The entropy-coded bytes of a scan, unstuffed on the fly. At a marker (or
// the end of the buffer) it supplies zero bits, as libjpeg does, and counts
// them: consuming one of them sets `exhausted` (jdhuff.c's
// insufficient_data), after which the scan decodes no further MCU until a
// restart marker.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;  // valid bits at the top
  int cnt = 0;
  int fake = 0;  // zero bits appended past the data
  bool at_marker = false;
  bool exhausted = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      if (at_marker) {
        fake += 8;
      } else if (pos >= n) {
        at_marker = true;
        fake += 8;
      } else if (d[pos] != 0xFF) {
        c = d[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;  // fill bytes
        if (q < n && d[q] == 0) {  // FF 00: a data byte of FF
          c = 0xFF;
          pos = q + 1;
        } else {  // a marker: pos stays on its first FF
          at_marker = true;
          fake += 8;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    cnt -= k;
    if (cnt < fake) exhausted = true;
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  int decode(const Huff& t) {
    uint32_t look = peek(16);
    uint16_t e = t.look[look >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(look >> (16 - l));
    while (code > t.maxcode[l]) {
      l++;
      if (l > 16) fail(CORRUPT, "corrupt JPEG data: bad Huffman code");
      code = static_cast<int32_t>(look >> (16 - l));
    }
    skip(l);
    return t.vals[code + t.valoffset[l]];
  }
  // drop what is buffered and move `pos` to the next marker, skipping any
  // extraneous bytes before it (libjpeg skips them with a warning); `pos`
  // is `n` when the data ends first
  void to_marker() {
    buf = 0;
    cnt = 0;
    fake = 0;
    at_marker = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF) {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] != 0) {
          pos = q - 1;  // on the FF right before the marker code
          return;
        }
        pos = q;
      } else {
        pos++;
      }
    }
    pos = n;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s)) + 1 : v; }

// ---------------------------------------------------------------- IDCT

// jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c prepare_range_limit_table, the post-IDCT part: the output
// sample for a descaled value masked to 10 bits
struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    for (int i = 0; i < 1024; i++) {
      int x = i < 512 ? i : i - 1024;  // the signed value the mask kept
      int v = x + 128;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
};
const IdctLimit kIdctLimit;

// The accurate IDCT as libjpeg-turbo's x86-64 SIMD version (jidctint-avx2)
// computes it, which is jidctint.c's where the values stay in range: the
// dequantised coefficients in 16 bits, the first pass's output saturated
// to 16 bits, the samples clamped (not range-limited through the mask).
// Only a block-smoothing estimate far out of range tells them apart.
inline int sat16(int64_t v) {
  return static_cast<int>(v > 32767 ? 32767 : (v < -32768 ? -32768 : v));
}
inline uint8_t clamp_sample(int64_t v) {
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    auto dq = [&](int r) -> int64_t {  // 16-bit products, as pmullw leaves them
      return static_cast<int16_t>(in[8 * r] * static_cast<int16_t>(qt[8 * r]));
    };
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = static_cast<int16_t>(dq(0) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = sat16(descale(tmp10 + tmp3, sh));
    w[56] = sat16(descale(tmp10 - tmp3, sh));
    w[8] = sat16(descale(tmp11 + tmp2, sh));
    w[48] = sat16(descale(tmp11 - tmp2, sh));
    w[16] = sat16(descale(tmp12 + tmp1, sh));
    w[40] = sat16(descale(tmp12 - tmp1, sh));
    w[24] = sat16(descale(tmp13 + tmp0, sh));
    w[32] = sat16(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = clamp_sample(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = clamp_sample(descale(tmp10 + tmp3, sh));
    o[7] = clamp_sample(descale(tmp10 - tmp3, sh));
    o[1] = clamp_sample(descale(tmp11 + tmp2, sh));
    o[6] = clamp_sample(descale(tmp11 - tmp2, sh));
    o[2] = clamp_sample(descale(tmp12 + tmp1, sh));
    o[5] = clamp_sample(descale(tmp12 - tmp1, sh));
    o[3] = clamp_sample(descale(tmp13 + tmp0, sh));
    o[4] = clamp_sample(descale(tmp13 - tmp0, sh));
  }
}

// jidctred.c: the reduced-size IDCTs libjpeg runs at DCT scale 1/2, 1/4
// and 1/8 (jpeg_idct_4x4, _2x2, _1x1), on the same CONST_BITS 13 and
// PASS1_BITS 2 and the same range limit
constexpr int64_t FIX_0_211164243 = 1730;
constexpr int64_t FIX_0_509795579 = 4176;
constexpr int64_t FIX_0_601344887 = 4926;
constexpr int64_t FIX_0_720959822 = 5906;
constexpr int64_t FIX_0_850430095 = 6967;
constexpr int64_t FIX_1_061594337 = 8697;
constexpr int64_t FIX_1_272758580 = 10426;
constexpr int64_t FIX_1_451774981 = 11893;
constexpr int64_t FIX_2_172734803 = 17799;
constexpr int64_t FIX_3_624509785 = 29692;

void idct_4x4(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[32];
  for (int c = 0; c < 8; c++) {
    if (c == 4) continue;  // the second pass does not read column 4
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    auto dq = [&](int r) -> int64_t {
      return static_cast<int64_t>(in[8 * r]) * static_cast<int16_t>(qt[8 * r]);
    };
    if (!in[8] && !in[16] && !in[24] && !in[40] && !in[48] && !in[56]) {
      int dc = static_cast<int>(dq(0) * (1 << kPass1Bits));
      for (int r = 0; r < 4; r++) w[8 * r] = dc;
      continue;
    }
    int64_t tmp0 = dq(0) * (int64_t(1) << (kConstBits + 1));
    int64_t tmp2 = dq(2) * FIX_1_847759065 + dq(6) * -FIX_0_765366865;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = dq(7), z2 = dq(5), z3 = dq(3), z4 = dq(1);
    tmp0 = z1 * -FIX_0_211164243 + z2 * FIX_1_451774981 + z3 * -FIX_2_172734803 +
           z4 * FIX_1_061594337;
    tmp2 = z1 * -FIX_0_509795579 + z2 * -FIX_0_601344887 + z3 * FIX_0_899976223 +
           z4 * FIX_2_562915447;
    const int sh = kConstBits - kPass1Bits + 1;
    w[0] = static_cast<int>(descale(tmp10 + tmp2, sh));
    w[24] = static_cast<int>(descale(tmp10 - tmp2, sh));
    w[8] = static_cast<int>(descale(tmp12 + tmp0, sh));
    w[16] = static_cast<int>(descale(tmp12 - tmp0, sh));
  }
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 4; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = lim[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 4; c++) o[c] = v;
      continue;
    }
    int64_t tmp0 = int64_t(w[0]) * (int64_t(1) << (kConstBits + 1));
    int64_t tmp2 = int64_t(w[2]) * FIX_1_847759065 + int64_t(w[6]) * -FIX_0_765366865;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    tmp0 = z1 * -FIX_0_211164243 + z2 * FIX_1_451774981 + z3 * -FIX_2_172734803 +
           z4 * FIX_1_061594337;
    tmp2 = z1 * -FIX_0_509795579 + z2 * -FIX_0_601344887 + z3 * FIX_0_899976223 +
           z4 * FIX_2_562915447;
    const int sh = kConstBits + kPass1Bits + 3 + 1;
    o[0] = lim[descale(tmp10 + tmp2, sh) & 1023];
    o[3] = lim[descale(tmp10 - tmp2, sh) & 1023];
    o[1] = lim[descale(tmp12 + tmp0, sh) & 1023];
    o[2] = lim[descale(tmp12 - tmp0, sh) & 1023];
  }
}

void idct_2x2(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[16];
  for (int c = 0; c < 8; c++) {
    if (c == 2 || c == 4 || c == 6) continue;  // not read by the second pass
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    auto dq = [&](int r) -> int64_t {
      return static_cast<int64_t>(in[8 * r]) * static_cast<int16_t>(qt[8 * r]);
    };
    if (!in[8] && !in[24] && !in[40] && !in[56]) {
      int dc = static_cast<int>(dq(0) * (1 << kPass1Bits));
      w[0] = w[8] = dc;
      continue;
    }
    int64_t tmp10 = dq(0) * (int64_t(1) << (kConstBits + 2));
    int64_t tmp0 = dq(7) * -FIX_0_720959822 + dq(5) * FIX_0_850430095 +
                   dq(3) * -FIX_1_272758580 + dq(1) * FIX_3_624509785;
    const int sh = kConstBits - kPass1Bits + 2;
    w[0] = static_cast<int>(descale(tmp10 + tmp0, sh));
    w[8] = static_cast<int>(descale(tmp10 - tmp0, sh));
  }
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 2; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[3] && !w[5] && !w[7]) {
      o[0] = o[1] = lim[descale(w[0], kPass1Bits + 3) & 1023];
      continue;
    }
    int64_t tmp10 = int64_t(w[0]) * (int64_t(1) << (kConstBits + 2));
    int64_t tmp0 = int64_t(w[7]) * -FIX_0_720959822 + int64_t(w[5]) * FIX_0_850430095 +
                   int64_t(w[3]) * -FIX_1_272758580 + int64_t(w[1]) * FIX_3_624509785;
    const int sh = kConstBits + kPass1Bits + 3 + 2;
    o[0] = lim[descale(tmp10 + tmp0, sh) & 1023];
    o[1] = lim[descale(tmp10 - tmp0, sh) & 1023];
  }
}

void idct_1x1(const int16_t* coef, const uint16_t* q, uint8_t* out, int) {
  int dc = static_cast<int>(int64_t(coef[0]) * static_cast<int16_t>(q[0]));
  out[0] = kIdctLimit.t[descale(dc, 3) & 1023];
}

// ------------------------------------------------------------- colour

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF rounding
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// -------------------------------------------------------------- parser

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int w = 0, hgt = 0;  // samples of the component (downsampled size)
  int stride = 0, rows = 0;  // plane size, whole MCUs
  int bw = 0, bh = 0;  // blocks across and down in the coefficient buffer (whole MCUs)
  bool scanned = false;
  uint16_t q[64];  // quantisation table, latched at the component's first scan
  int coef_bits[64];  // progressive: the last Al of each coefficient, -1 before any scan
  int prev_bits[10];  // coef_bits[0-9] before the latest scan of the component
  std::vector<int16_t> coef;  // bw x bh blocks of 64 coefficients, natural order
  int ss = 8;  // the DCT's output size at the decode's scale (jdmaster.c)
  int sw = 0, sh = 0;  // samples of the component at that scale
  std::vector<uint8_t> plane;  // bw x bh blocks of ss x ss samples
  int16_t* block(int bx, int by) { return coef.data() + (size_t(by) * bw + bx) * 64; }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool saw_app1 = false;
  int orientation = 1;
  bool frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[4];
  int force_color = -1;  // -1: libjpeg's guess; 0: as stored; 1: YCbCr/YCCK
  bool in_scans = false;  // past the first SOS: the end of the data reads as EOI
  bool truncated = false;  // the data ended before EOI
  int scans = 0;  // SOS markers read
  // the first iMCU row of the last scan whose data ran out, or -1 when the
  // last scan ran to its end (libjpeg-turbo's last_good_iMCU_row + 1)
  int cut_row = -1;
  int scale = 8;  // the DCT output size of the decode: 8, or 4, 2, 1 at 1/2, 1/4, 1/8
  int out_w = 0, out_h = 0;  // the output size at that scale

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  // the next header byte; past the first scan the end of the data reads as
  // the source manager's fake EOI bytes, FF D9 over and over, so that a
  // table cut short fails or not as libjpeg's marker reader does
  int u8() {
    if (pos < n) return d[pos++];
    if (!in_scans) fail(TRUNCATED, "truncated JPEG file: it ends inside a header");
    truncated = true;
    return (pos++ - n) % 2 ? 0xD9 : 0xFF;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
  // the code of the next marker; fill bytes are skipped, other bytes raise.
  // Past the first scan the end of the data is the fake EOI of OpenCV's
  // source manager (jdatasrc.c fill_input_buffer).
  int next_marker() {
    if (in_scans && pos >= n) return eof();
    if (u8() != 0xFF) fail(CORRUPT, "corrupt JPEG file: a marker was expected");
    int m;
    do {
      if (in_scans && pos >= n) return eof();
      m = u8();
    } while (m == 0xFF);
    return m;
  }
  int eof() {
    truncated = true;
    pos = n;
    return 0xD9;
  }
  // the payload of a segment: [pos, end)
  size_t segment() {
    int len = u16();
    if (len < 2 || (!in_scans && pos + len - 2 > n))
      fail(TRUNCATED, "truncated JPEG file: a segment of %d bytes runs past the end", len);
    return pos + len - 2;
  }

  void dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail(CORRUPT, "corrupt JPEG file: bad DQT");
      for (int k = 0; k < 64; k++) qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    if (pos != end) fail(CORRUPT, "corrupt JPEG file: bad DQT length");
  }

  void dht(size_t end) {
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail(CORRUPT, "corrupt JPEG file: bad DHT");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; l++) count += (bits[l] = static_cast<uint8_t>(u8()));
      if (count > 256) fail(CORRUPT, "corrupt JPEG file: bad DHT");
      uint8_t vals[256];
      for (int i = 0; i < count; i++) vals[i] = static_cast<uint8_t>(u8());
      Huff& t = tc ? ac[th] : dc[th];
      build_huff(t, bits, vals, count, tc == 0);
      t.defined = true;
    }
    if (pos != end) fail(CORRUPT, "corrupt JPEG file: bad DHT length");
  }

  void sof(size_t end, bool prog) {
    if (frame) fail(CORRUPT, "corrupt JPEG file: a second SOF");
    progressive = prog;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail(UNSUPPORTED, "%d-bit JPEG; the port decodes 8-bit JPEG only", precision);
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(UNSUPPORTED, "%d-component JPEG; the port decodes 1, 3 and 4 components", ncomp);
    if (width == 0 || height == 0)
      fail(UNSUPPORTED, "JPEG of size %dx%d (a DNL-defined height is not supported)", width,
           height);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(CORRUPT, "corrupt JPEG file: bad SOF component");
    }
    if (pos != end) fail(CORRUPT, "corrupt JPEG file: bad SOF length");
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // one component: one block an MCU
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      if (comp[i].h > hmax) hmax = comp[i].h;
      if (comp[i].v > vmax) vmax = comp[i].v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.w = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.hgt = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.stride = c.bw * 8;
      c.rows = c.bh * 8;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    frame = true;
  }

  void app(int marker, size_t end) {
    size_t len = end - pos;
    const uint8_t* p = d + pos;
    if (marker == 0xE0 && len >= 14 && !std::memcmp(p, "JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && len >= 12 && !std::memcmp(p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = p[11];
    }
    if (marker == 0xE1 && !saw_app1) {  // OpenCV parses the first APP1 only
      saw_app1 = true;
      if (len > 6) orientation = exif_orientation(p + 6, len - 6);
    }
    pos = end;
  }

  // OpenCV's ExifReader: the TIFF header after the 6 bytes of "Exif\0\0"
  // (not checked), IFD0's first orientation entry; 1 when anything is off
  static int exif_orientation(const uint8_t* t, size_t len) {
    if (len < 8) return 1;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 1;
    auto rd16 = [&](size_t o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    if (rd16(2) != 0x2A) return 1;
    uint32_t off = le ? (t[4] | (t[5] << 8) | (t[6] << 16) | (uint32_t(t[7]) << 24))
                      : ((uint32_t(t[4]) << 24) | (t[5] << 16) | (t[6] << 8) | t[7]);
    if (size_t(off) + 2 > len) return 1;
    int entries = rd16(off);
    for (int i = 0; i < entries; i++) {
      size_t e = size_t(off) + 2 + 12 * size_t(i);
      if (e + 10 > len) return 1;
      if (rd16(e) == 0x0112) {
        int v = rd16(e + 8);
        return v >= 1 && v <= 8 ? v : 1;
      }
    }
    return 1;
  }

  // an APPn or COM segment: past the first scan one that runs past the end
  // is skipped into the fake EOI (libjpeg skips it through the fake bytes)
  size_t skippable_segment() {
    if (in_scans && pos + 2 <= n) {
      size_t len = (size_t(d[pos]) << 8) | d[pos + 1];
      if (len >= 2 && pos + len > n) {
        eof();
        return n;
      }
    }
    if (in_scans && pos + 2 > n) {
      eof();
      return n;
    }
    return segment();
  }

  // the markers up to the first SOS (or EOI); returns the marker that ended it
  int headers() {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail(CORRUPT, "not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA || m == 0xD9) return m;
      segment_marker(m);
    }
  }

  void segment_marker(int m) {
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: {
        size_t e = segment();
        sof(e, m == 0xC2);
        return;
      }
      case 0xC3: fail(UNSUPPORTED, "lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        fail(UNSUPPORTED, "hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
      case 0xC9: case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE: case 0xCF:
        fail(UNSUPPORTED, "arithmetic-coded JPEG (marker 0x%02X) is not supported", m);
      case 0xC4: { size_t e = segment(); dht(e); return; }
      case 0xDB: { size_t e = segment(); dqt(e); return; }
      case 0xDD: {
        size_t e = segment();
        restart_interval = u16();
        if (pos != e) fail(CORRUPT, "corrupt JPEG file: bad DRI length");
        return;
      }
      case 0xFE: { size_t e = skippable_segment(); pos = e; return; }
      case 0xDC: fail(UNSUPPORTED, "JPEG with a DNL marker is not supported");
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          size_t e = skippable_segment();
          app(m, e);
          return;
        }
        fail(CORRUPT, "corrupt JPEG file: unexpected marker 0x%02X", m);
    }
  }

  // One scan, from its SOS header; leaves pos on the marker after it. The
  // MCUs decode into the components' coefficient buffers: sequential scans
  // as jdhuff.c, progressive ones as jdphuff.c (DC first and refine, AC
  // first with EOBRUN and AC refine).
  void scan() {
    if (!frame) fail(CORRUPT, "corrupt JPEG file: SOS before SOF");
    size_t end = segment();
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail(CORRUPT, "corrupt JPEG file: bad SOS");
    Comp* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = u8(), tdta = u8();
      Comp* c = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) c = &comp[k];
      if (!c) fail(CORRUPT, "corrupt JPEG file: SOS names an unknown component");
      c->td = tdta >> 4;
      c->ta = tdta & 15;
      if (c->td > 3 || c->ta > 3) fail(CORRUPT, "corrupt JPEG file: bad SOS table");
      sc[i] = c;
    }
    const int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    if (pos != end) fail(CORRUPT, "corrupt JPEG file: bad SOS length");
    in_scans = true;
    scans++;
    if (progressive) {  // jdphuff.c start_pass_phuff_decoder
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(CORRUPT, "corrupt JPEG file: bad progression parameters Ss=%d Se=%d", ss, se);
      for (int i = 0; i < ns; i++) {
        for (int k = ss < 1 ? ss : 1; k <= 9; k++)
          sc[i]->prev_bits[k] = scans > 1 ? sc[i]->coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) sc[i]->coef_bits[k] = al;
      }
    }
    const bool dc_first = progressive && ss == 0 && ah == 0;
    const bool dc_refine = progressive && ss == 0 && ah != 0;
    const bool ac_scan = progressive && ss != 0;
    for (int i = 0; i < ns; i++) {
      const Comp& c = *sc[i];
      bool need_dc = !progressive || dc_first, need_ac = !progressive || ac_scan;
      if ((need_dc && !dc[c.td].defined) || (need_ac && !ac[c.ta].defined))
        fail(CORRUPT, "corrupt JPEG file: a scan uses an undefined Huffman table");
    }
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      if (!c.scanned) {  // jdinput.c latch_quant_tables
        if (!qt_defined[c.tq]) fail(CORRUPT, "corrupt JPEG file: undefined quantisation table");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.scanned = true;
      }
      if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      blocks_in_mcu += ns == 1 ? 1 : c.h * c.v;
    }
    if (blocks_in_mcu > 10) fail(CORRUPT, "corrupt JPEG file: more than 10 blocks an MCU");
    int bw = mcux, bh = mcuy;
    if (ns == 1) {
      bw = (sc[0]->w + 7) / 8;
      bh = (sc[0]->hgt + 7) / 8;
    }
    Bits bits{d, n, pos};
    cut_row = -1;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int next_rst = 0;
    const int64_t total = int64_t(bw) * bh;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        // jdhuff.c process_restart: the predictions and EOBRUN reset; the
        // expected RSTn clears `exhausted`, the end of the data keeps it
        bits.to_marker();
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
        if (bits.pos < n) {
          if (bits.pos + 1 >= n || d[bits.pos + 1] != 0xD0 + next_rst)
            fail(CORRUPT, "corrupt JPEG data: restart marker RST%d missing", next_rst);
          bits.pos += 2;
          bits.exhausted = false;
        } else {
          bits.at_marker = true;
        }
        next_rst = (next_rst + 1) & 7;
      }
      // jdhuff.c decode_mcu: once the data ran out, the MCU keeps its zeros
      if (bits.exhausted) continue;
      int mx = static_cast<int>(m % bw), my = static_cast<int>(m / bw);
      for (int i = 0; i < ns; i++) {
        Comp& c = *sc[i];
        int bh_c = ns == 1 ? 1 : c.v, bw_c = ns == 1 ? 1 : c.h;
        for (int y = 0; y < bh_c; y++)
          for (int x = 0; x < bw_c; x++) {
            int16_t* blk = c.block(mx * bw_c + x, my * bh_c + y);
            if (!progressive) decode_sequential(bits, c, pred[i], blk);
            else if (dc_first) decode_dc_first(bits, c, pred[i], al, blk);
            else if (dc_refine) blk[0] |= static_cast<int16_t>(bits.get(1) << al);
            else if (ah == 0) decode_ac_first(bits, c, ss, se, al, eobrun, blk);
            else decode_ac_refine(bits, c, ss, se, al, eobrun, blk);
          }
      }
      if (bits.exhausted && cut_row < 0) cut_row = ns == 1 ? my / sc[0]->v : my;
    }
    bits.to_marker();
    pos = bits.pos;
  }

  void decode_sequential(Bits& bits, const Comp& c, int& pred, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));  // jdcoefct.c zeroes the MCU first
    int s = bits.decode(dc[c.td]);
    int diff = s ? extend(bits.get(s), s) : 0;
    pred = static_cast<int>(static_cast<uint32_t>(pred) + static_cast<uint32_t>(diff));
    blk[0] = static_cast<int16_t>(pred);
    const Huff& a = ac[c.ta];
    for (int k = 1; k < 64; k++) {
      int rs = bits.decode(a);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail(CORRUPT, "corrupt JPEG data: coefficient index past 63");
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(Bits& bits, const Comp& c, int& pred, int al, int16_t* blk) {
    int s = bits.decode(dc[c.td]);
    int diff = s ? extend(bits.get(s), s) : 0;
    pred = static_cast<int>(static_cast<uint32_t>(pred) + static_cast<uint32_t>(diff));
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(pred) << al);
  }

  void decode_ac_first(Bits& bits, const Comp& c, int ss, int se, int al, int& eobrun,
                       int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& a = ac[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = bits.decode(a);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(bits.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits.get(r);
        eobrun--;
        break;
      }
    }
  }

  void decode_ac_refine(Bits& bits, const Comp& c, int ss, int se, int al, int& eobrun,
                        int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huff& a = ac[c.ta];
    auto refine = [&](int16_t& coef) {
      if (bits.get(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = bits.decode(a);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.get(1) ? p1 : m1;  // a size other than 1 is corrupt; libjpeg warns only
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) refine(coef);
          else if (--r < 0) break;
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) refine(coef);
      }
      eobrun--;
    }
  }

  // headers, then every scan, up to EOI or the end of the data
  void decode() {
    int m = headers();
    if (m == 0xD9 || !frame) fail(CORRUPT, "corrupt JPEG file: no image before EOI");
    for (;;) {
      if (m == 0xDA) scan();
      else if (m == 0xD9) break;
      else segment_marker(m);
      m = next_marker();
    }
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 3): every component latched with
  // nonzero DC and first nine AC quantisers and some DC bits known, and some
  // of AC coefficients 1-9 of some component not final
  bool smoothing_applies() const {
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Comp& c = comp[i];
      if (!c.scanned) return false;
      for (int k = 0; k < 10; k++)
        if (c.q[kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdmaster.c: the output size and each component's DCT output size at
  // scale 1/(8 / scale), scale in {8, 4, 2, 1}. A chroma component takes a
  // larger IDCT in place of upsampling where its sampling allows.
  void set_scale(int s) {
    scale = s;
    out_w = static_cast<int>((int64_t(width) * scale + 7) / 8);
    out_h = static_cast<int>((int64_t(height) * scale + 7) / 8);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      int ssize = scale;
      while (ssize < 8 && (hmax * scale) % (c.h * ssize * 2) == 0 &&
             (vmax * scale) % (c.v * ssize * 2) == 0)
        ssize *= 2;
      c.ss = ssize;
      c.sw = static_cast<int>((int64_t(width) * c.h * ssize + hmax * 8 - 1) / (hmax * 8));
      c.sh = static_cast<int>((int64_t(height) * c.v * ssize + vmax * 8 - 1) / (vmax * 8));
    }
  }

  // The IDCT of every block into the component's plane, at the scale
  // set_scale chose; a component with no scan is all zero coefficients, 128
  // everywhere. A progressive image whose first AC coefficients are not all
  // final is block-smoothed as libjpeg does it (jdcoefct.c).
  void reconstruct(int scale = 8) {
    set_scale(scale);
    const bool smooth = progressive && smoothing_applies();
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      const int ss = c.ss, stride = c.bw * ss;
      if (c.coef.empty()) {
        c.plane.assign(size_t(stride) * c.bh * ss, 128);
        continue;
      }
      c.plane.assign(size_t(stride) * c.bh * ss, 0);
      void (*idct)(const int16_t*, const uint16_t*, uint8_t*, int) =
          ss == 8 ? idct_islow : ss == 4 ? idct_4x4 : ss == 2 ? idct_2x2 : idct_1x1;
      if (smooth) {
        smooth_component(c, idct);
        continue;
      }
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct(c.block(bx, by), c.q, c.plane.data() + size_t(by) * ss * stride + size_t(bx) * ss,
               stride);
    }
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
  // block of the component, with those of its first nine AC coefficients
  // that are zero and not final estimated from the DC values of the 5x5
  // blocks around it, and with its DC value re-estimated too where no AC
  // bits are known at all. An iMCU row past the one where the last scan's
  // data ran out takes the coefficient bits from before that scan.
  void smooth_component(Comp& c, void (*idct)(const int16_t*, const uint16_t*, uint8_t*, int)) {
    const int ss = c.ss, stride = c.bw * ss;
    const int wb = (c.w + 7) / 8, hb = (c.hgt + 7) / 8;  // blocks of the image proper
    const int64_t Q00 = c.q[0];
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    int64_t Q[10];
    for (int k = 0; k < 10; k++) Q[k] = c.q[kPos[k]];
    int cur[10], prev[10];
    cur[0] = prev[0] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) {
      cur[k] = c.coef_bits[k];
      prev[k] = scans > 1 ? c.prev_bits[k] : -1;
    }
    int16_t ws[64];
    for (int by = 0; by < hb; by++) {
      // the rows of DC values two above to two below, as libjpeg-turbo 3
      // picks them: from the row's index counted in the block rows of its
      // own iMCU row (fewer in a partial last one) against that count times
      // the iMCU rows, so that the row two below may be an MCU's padding row
      // and a small image's last iMCU row sees no row two above (2.1 decides
      // by the iMCU rows instead; the tests note where the two differ)
      const int r = by / c.v, b = by % c.v;
      const int block_rows = r < mcuy - 1 ? c.v : (hb % c.v ? hb % c.v : c.v);
      const int ibr = r * block_rows + b, ibrs = block_rows * mcuy;
      const int p1 = ibr > 0 ? by - 1 : by, p2 = ibr > 1 ? by - 2 : p1;
      const int n1 = ibr < ibrs - 1 ? by + 1 : by, n2 = ibr < ibrs - 2 ? by + 2 : n1;
      const int rows[5] = {p2, p1, by, n1, n2};
      const int* bits = (cut_row >= 0 && r > cut_row) ? prev : cur;
      bool change_dc = true;
      for (int k = 1; k < 10; k++)
        if (bits[k] != -1) change_dc = false;
      for (int bx = 0; bx < wb; bx++) {
        int DC[26];
        for (int y = 0; y < 5; y++)
          for (int x = 0; x < 5; x++) {
            int cx = bx + x - 2;
            cx = cx < 0 ? 0 : (cx >= wb ? wb - 1 : cx);
            DC[1 + 5 * y + x] = c.block(cx, rows[y])[0];
          }
        std::memcpy(ws, c.block(bx, by), sizeof(ws));
        auto estimate = [&](int k, int pos, int64_t sum) {
          int al = bits[k];
          if (al == 0 || ws[pos] != 0) return;
          int64_t num = Q00 * sum;
          int pred;
          if (num >= 0) {
            pred = static_cast<int>(((Q[k] << 7) + num) / (Q[k] << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          } else {
            pred = static_cast<int>(((Q[k] << 7) - num) / (Q[k] << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
          }
          ws[pos] = static_cast<int16_t>(pred);
        };
        const int64_t DC01 = DC[1], DC02 = DC[2], DC03 = DC[3], DC04 = DC[4], DC05 = DC[5],
                      DC06 = DC[6], DC07 = DC[7], DC08 = DC[8], DC09 = DC[9], DC10 = DC[10],
                      DC11 = DC[11], DC12 = DC[12], DC13 = DC[13], DC14 = DC[14], DC15 = DC[15],
                      DC16 = DC[16], DC17 = DC[17], DC18 = DC[18], DC19 = DC[19], DC20 = DC[20],
                      DC21 = DC[21], DC22 = DC[22], DC23 = DC[23], DC24 = DC[24], DC25 = DC[25];
        estimate(1, 1, change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                    13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                                    3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                                    DC21 - DC22 + DC24 + DC25)
                                 : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
        estimate(2, 8, change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                    13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                    13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                    3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                 : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
        estimate(3, 16, change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                     14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                                     DC23)
                                  : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
        estimate(4, 9, change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                    DC21 - DC25)
                                 : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                    DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
        estimate(5, 2, change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                    14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                    2 * DC19)
                                 : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
        if (change_dc) {
          estimate(6, 3, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
          estimate(7, 10, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
          estimate(8, 17, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
          estimate(9, 24, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
          int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                               6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                               8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                               6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          int pred = num >= 0 ? static_cast<int>(((Q00 << 7) + num) / (Q00 << 8))
                              : -static_cast<int>(((Q00 << 7) - num) / (Q00 << 8));
          ws[0] = static_cast<int16_t>(pred);
        }
        idct(ws, c.q, c.plane.data() + size_t(by) * ss * stride + size_t(bx) * ss, stride);
      }
    }
  }

  // the planes as FFmpeg's MJPEG decoder reconstructs them: coefficients
  // dequantised into 16 bits, the DC offset by its predictor's start (1024,
  // the level shift), the simple IDCT
  void reconstruct_simple() {
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      if (c.coef.empty()) {
        c.plane.assign(size_t(c.stride) * c.rows, 128);
        continue;
      }
      c.plane.assign(size_t(c.stride) * c.rows, 0);
      int16_t blk[64];
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++) {
          const int16_t* in = c.block(bx, by);
          for (int k = 0; k < 64; k++) blk[k] = static_cast<int16_t>(in[k] * c.q[k]);
          blk[0] = static_cast<int16_t>(in[0] * c.q[0] + 1024);
          uint8_t* out = c.plane.data() + size_t(by) * 8 * c.stride + size_t(bx) * 8;
          yolov6_simple_idct::simple_idct(blk, out, c.stride, false);
        }
    }
  }

  // the component upsampled to the output size (jdsample.c's choice of
  // method; no fancy upsampling at scale 1/8, where jdmainct.c has no
  // context rows)
  std::vector<uint8_t> upsample(const Comp& c) const {
    std::vector<uint8_t> out(size_t(out_w) * out_h);
    const int hin = c.h * c.ss / scale, vin = c.v * c.ss / scale;
    if (hin == 0 || vin == 0 || hmax % hin || vmax % vin)
      fail(UNSUPPORTED, "JPEG with fractional chroma sampling is not supported");
    const int he = hmax / hin, ve = vmax / vin;
    const int cw = c.sw, ch = c.sh, stride = c.bw * c.ss;
    const bool fancy = scale > 1;
    const uint8_t* p = c.plane.data();
    auto at = [&](int y, int x) -> int { return p[size_t(y) * stride + x]; };
    auto rowc = [&](int y) { return y < 0 ? 0 : (y >= ch ? ch - 1 : y); };
    auto colc = [&](int x) { return x < 0 ? 0 : (x >= cw ? cw - 1 : x); };
    const bool h2v1 = fancy && he == 2 && ve == 1 && cw > 2;
    const bool h1v2 = fancy && he == 1 && ve == 2;
    const bool h2v2 = fancy && he == 2 && ve == 2 && cw > 2;
    for (int y = 0; y < out_h; y++) {
      uint8_t* o = out.data() + size_t(y) * out_w;
      if (h2v1) {
        for (int x = 0; x < out_w; x++) {
          int i = x >> 1, near = 3 * at(y, i);
          o[x] = static_cast<uint8_t>(x & 1 ? (near + at(y, colc(i + 1)) + 2) >> 2
                                             : (near + at(y, colc(i - 1)) + 1) >> 2);
        }
      } else if (h1v2) {
        int j = y >> 1, far = rowc(y & 1 ? j + 1 : j - 1), bias = y & 1 ? 2 : 1;
        for (int x = 0; x < out_w; x++)
          o[x] = static_cast<uint8_t>((3 * at(j, x) + at(far, x) + bias) >> 2);
      } else if (h2v2) {
        int j = y >> 1, far = rowc(y & 1 ? j + 1 : j - 1);
        auto colsum = [&](int i) { return 3 * at(j, i) + at(far, i); };
        for (int x = 0; x < out_w; x++) {
          int i = x >> 1, near = 3 * colsum(i);
          o[x] = static_cast<uint8_t>(x & 1 ? (near + colsum(colc(i + 1)) + 7) >> 4
                                             : (near + colsum(colc(i - 1)) + 8) >> 4);
        }
      } else {  // full size, or replication by the integral factors
        int j = y / ve;
        for (int x = 0; x < out_w; x++) o[x] = static_cast<uint8_t>(at(j, x / he));
      }
    }
    return out;
  }

  // the four components as libjpeg's CMYK output gives them (YCCK
  // converted), HxWx4, into `out`
  void output_cmyk(uint8_t* out) const {
    if (ncomp != 4) fail(UNSUPPORTED, "%d-component JPEG read as CMYK", ncomp);
    std::vector<uint8_t> p[4] = {upsample(comp[0]), upsample(comp[1]), upsample(comp[2]),
                                 upsample(comp[3])};
    const bool ycck = force_color >= 0 ? force_color == 1 : (adobe && adobe_transform != 0);
    const size_t npx = size_t(out_w) * out_h;
    for (size_t i = 0; i < npx; i++) {
      uint8_t* o = out + 4 * i;
      if (ycck) {
        int yy = p[0][i], cb = p[1][i], cr = p[2][i];
        o[0] = clamp255(255 - (yy + kYcc.cr_r[cr]));
        o[1] = clamp255(255 - (yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
        o[2] = clamp255(255 - (yy + kYcc.cb_b[cb]));
      } else {
        o[0] = p[0][i];
        o[1] = p[1][i];
        o[2] = p[2][i];
      }
      o[3] = p[3][i];
    }
  }

  // BGR (or with `rgb_order` RGB), HxWx3 at the output size, into `out`
  void output(uint8_t* out, bool rgb_order = false) const {
    const size_t npx = size_t(out_w) * out_h;
    const int ob = rgb_order ? 2 : 0, orr = 2 - ob;  // where blue and red go
    if (ncomp == 1) {
      const Comp& c = comp[0];
      const int stride = c.bw * c.ss;
      for (int y = 0; y < out_h; y++)
        for (int x = 0; x < out_w; x++) {
          uint8_t g = c.plane[size_t(y) * stride + x];
          uint8_t* o = out + (size_t(y) * out_w + x) * 3;
          o[0] = o[1] = o[2] = g;
        }
      return;
    }
    if (ncomp == 4) {  // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
      std::vector<uint8_t> cmyk(npx * 4);
      output_cmyk(cmyk.data());
      for (size_t i = 0; i < npx; i++) {
        const uint8_t* q = cmyk.data() + 4 * i;
        const int k = q[3];
        uint8_t* o = out + 3 * i;
        o[2] = static_cast<uint8_t>(k - (((255 - q[0]) * k) >> 8));
        o[1] = static_cast<uint8_t>(k - (((255 - q[1]) * k) >> 8));
        o[0] = static_cast<uint8_t>(k - (((255 - q[2]) * k) >> 8));
      }
      return;
    }
    std::vector<uint8_t> p0 = upsample(comp[0]), p1 = upsample(comp[1]), p2 = upsample(comp[2]);
    // jdapimin.c default_decompress_parms: JFIF first, then Adobe, then the ids
    bool rgb = false;
    if (force_color >= 0) {
      rgb = force_color == 0;
    } else if (!jfif) {
      if (adobe) rgb = adobe_transform == 0;
      else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }
    for (size_t i = 0; i < npx; i++) {
      uint8_t* o = out + 3 * i;
      if (rgb) {
        o[ob] = p2[i];
        o[1] = p1[i];
        o[orr] = p0[i];
        continue;
      }
      int y = p0[i], cb = p1[i], cr = p2[i];
      o[orr] = clamp255(y + kYcc.cr_r[cr]);
      o[1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[ob] = clamp255(y + kYcc.cb_b[cb]);
    }
  }
};

int run(char* err, int errlen, void (*body)(void*), void* arg) {
  try {
    body(arg);
    return OK;
  } catch (const Fail& f) {
    std::snprintf(err, errlen, "%s", f.msg);
    return f.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, errlen, "out of memory decoding the JPEG");
    return INTERNAL;
  } catch (...) {
    std::snprintf(err, errlen, "internal error decoding the JPEG");
    return INTERNAL;
  }
}

struct InfoArgs {
  const uint8_t* d;
  size_t n;
  int* w;
  int* h;
  int* orientation;
  int* components;
};

struct DecodeArgs {
  const uint8_t* d;
  size_t n;
  uint8_t* out;
  int w, h;
  int* truncated;
  int force_color;
  bool cmyk = false;
};

void decode_body(void* p) {
  DecodeArgs& a = *static_cast<DecodeArgs*>(p);
  Decoder dec(a.d, a.n);
  dec.force_color = a.force_color;
  dec.decode();
  if (dec.width != a.w || dec.height != a.h)
    fail(INTERNAL, "output buffer is %dx%d pixels, not the image's size", a.w, a.h);
  dec.reconstruct();
  if (a.cmyk) dec.output_cmyk(a.out);
  else dec.output(a.out);
  *a.truncated = dec.truncated;
}

// std::floor and std::lround of a float, exactly, without <cmath>
inline int floor_int(float v) {
  int i = static_cast<int>(v);
  return v < static_cast<float>(i) ? i - 1 : i;
}
inline long round_half_away(float v) {  // the double holds v + 0.5 exactly
  return v < 0 ? -static_cast<long>(0.5 - static_cast<double>(v))
               : static_cast<long>(static_cast<double>(v) + 0.5);
}

// The JAX package's native train-path resize (native/dataload.cc
// BilinearResize): float32, half-pixel centres, std::lround. Built, like
// that library, with no floating-point contraction, so that it gives its
// bytes.
void bilinear_resize(const uint8_t* src, int h, int w, uint8_t* dst, int dh, int dw) {
  const float sx = static_cast<float>(w) / dw;
  const float sy = static_cast<float>(h) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = floor_int(fy);
    float wy = fy - y0;
    int y1 = y0 + 1 < h - 1 ? y0 + 1 : h - 1;
    y0 = y0 > 0 ? y0 : 0;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    const uint8_t* srow0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* srow1 = src + static_cast<size_t>(y1) * w * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = floor_int(fx);
      float wx = fx - x0;
      int x1 = x0 + 1 < w - 1 ? x0 + 1 : w - 1;
      x0 = x0 > 0 ? x0 : 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = srow0[x0 * 3 + c], v01 = srow0[x1 * 3 + c];
        float v10 = srow1[x0 * 3 + c], v11 = srow1[x1 * 3 + c];
        float v0 = v00 + (v01 - v00) * wx;
        float v1 = v10 + (v11 - v10) * wx;
        drow[x * 3 + c] = static_cast<uint8_t>(round_half_away(v0 + (v1 - v0) * wy));
      }
    }
  }
}

}  // namespace

extern "C" {

// Width, height (as stored, before any orientation), the Exif orientation
// (1-8; 1 when there is none) and the number of components from the headers
// before the first scan.
int yolov6_jpeg_info(const uint8_t* data, size_t size, int* width, int* height, int* orientation,
                     int* components, char* err, int errlen) {
  InfoArgs a{data, size, width, height, orientation, components};
  return run(err, errlen, [](void* p) {
    InfoArgs& a = *static_cast<InfoArgs*>(p);
    Decoder dec(a.d, a.n);
    int m = dec.headers();
    if (m != 0xDA || !dec.frame) fail(CORRUPT, "corrupt JPEG file: no frame before the scan");
    *a.w = dec.width;
    *a.h = dec.height;
    *a.orientation = dec.orientation;
    *a.components = dec.ncomp;
  }, &a);
}

// Decode into `out`, height x width x 3 BGR bytes as stored (the caller
// applies the orientation); `width` and `height` must be yolov6_jpeg_info's.
// `truncated` is set to 1 when the data ended before EOI (the image is
// libjpeg's all the same), else 0. `force_color` -1 takes libjpeg's guess of
// the colour space, 0 takes the components as stored (RGB or CMYK) and 1
// as YCbCr (YCCK), as libtiff sets them for a JPEG-compressed TIFF.
int yolov6_jpeg_decode_as(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                          int force_color, int* truncated, char* err, int errlen) {
  DecodeArgs a{data, size, out, width, height, truncated, force_color};
  return run(err, errlen, decode_body, &a);
}

// Decode a 4-component JPEG into `out`, height x width x 4 bytes: the CMYK
// samples libjpeg's JCS_CMYK output gives (YCCK converted), which PIL holds
// (inverted) for a CMYK JPEG.
int yolov6_jpeg_decode_cmyk(const uint8_t* data, size_t size, uint8_t* out, int width,
                            int height, int* truncated, char* err, int errlen) {
  DecodeArgs a{data, size, out, width, height, truncated, -1, true};
  return run(err, errlen, decode_body, &a);
}

// Decode as libjpeg does with out_color_space JCS_RGB at scale_num 1,
// scale_denom `denom` (1, 2, 4 or 8), its defaults otherwise (accurate
// integer IDCT, or at the scale jidctred.c's reduced IDCTs; fancy
// upsampling but at 1/8; block smoothing): `width` x `height` x 3 RGB bytes
// into `out`, each side yolov6_jpeg_info's divided by `denom` and rounded
// up (jdiv_round_up), no orientation.
// Grey comes out as RGB. A 4-component file (CMYK, YCCK), which libjpeg
// does not convert to RGB, returns NOT_RGB.
int yolov6_jpeg_decode_scaled(const uint8_t* data, size_t size, int denom, uint8_t* out,
                              int width, int height, int* truncated, char* err, int errlen) {
  struct Args {
    const uint8_t* d;
    size_t n;
    int denom;
    uint8_t* out;
    int w, h;
    int* truncated;
  } a{data, size, denom, out, width, height, truncated};
  return run(err, errlen, [](void* p) {
    Args& a = *static_cast<Args*>(p);
    if (a.denom != 1 && a.denom != 2 && a.denom != 4 && a.denom != 8)
      fail(INTERNAL, "DCT scale 1/%d: the denominator is 1, 2, 4 or 8", a.denom);
    Decoder dec(a.d, a.n);
    dec.decode();
    if (dec.ncomp == 4)
      fail(NOT_RGB, "4-component (CMYK or YCCK) JPEG: libjpeg converts it to no RGB");
    dec.reconstruct(8 / a.denom);
    if (dec.out_w != a.w || dec.out_h != a.h)
      fail(INTERNAL, "output buffer is %dx%d pixels, not the scaled image's size", a.w, a.h);
    dec.output(a.out, true);
    *a.truncated = dec.truncated;
  }, &a);
}

// `src` (h x w x 3 bytes) resized to `dh` x `dw` x 3 into `dst` as the JAX
// package's native train path resizes (bilinear_resize).
void yolov6_bilinear_resize(const uint8_t* src, int h, int w, uint8_t* dst, int dh, int dw) {
  bilinear_resize(src, h, w, dst, dh, dw);
}

// Decode into planes as FFmpeg's MJPEG decoder does (reconstruct_simple):
// component i's samples (dims[2i] wide, dims[2i + 1] high, its own
// subsampled size) one after another into `out` (width * height * 3 bytes
// are enough); *ncomp is 1 (grey) or 3.
int yolov6_jpeg_decode_planes(const uint8_t* data, size_t size, uint8_t* out, int width,
                              int height, int* ncomp, int* dims, int* truncated, char* err,
                              int errlen) {
  struct Args {
    const uint8_t* d;
    size_t n;
    uint8_t* out;
    int w, h;
    int* ncomp;
    int* dims;
    int* truncated;
  } a{data, size, out, width, height, ncomp, dims, truncated};
  return run(err, errlen, [](void* p) {
    Args& a = *static_cast<Args*>(p);
    Decoder dec(a.d, a.n);
    dec.decode();
    if (dec.width != a.w || dec.height != a.h)
      fail(INTERNAL, "output buffer is %dx%d pixels, not the image's size", a.w, a.h);
    if (dec.ncomp != 1 && dec.ncomp != 3)
      fail(UNSUPPORTED, "%d-component JPEG as a video frame", dec.ncomp);
    dec.reconstruct_simple();
    uint8_t* o = a.out;
    for (int i = 0; i < dec.ncomp; i++) {
      const Comp& c = dec.comp[i];
      a.dims[2 * i] = c.w;
      a.dims[2 * i + 1] = c.hgt;
      for (int y = 0; y < c.hgt; y++, o += c.w)
        std::memcpy(o, c.plane.data() + size_t(y) * c.stride, c.w);
    }
    *a.ncomp = dec.ncomp;
    *a.truncated = dec.truncated;
  }, &a);
}

}  // extern "C"
