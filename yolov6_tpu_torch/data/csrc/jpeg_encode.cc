// Baseline JPEG encoder that writes the bytes cv2.imencode('.jpg', img)
// writes: libjpeg-turbo's default compression as OpenCV drives it
// (jpeg_set_defaults, jpeg_set_quality(q, TRUE), no optimised tables, no
// restart interval): jccolor.c's fixed-point BGR->YCbCr, jcsample.c's h2v2
// downsampling with its alternating 1/2 bias and edge expansion,
// jcprepct.c's bottom padding, jfdctint.c's accurate integer DCT,
// jcdctmgr.c's reciprocal quantiser, jccoefct.c's dummy blocks at the right
// and bottom edges, the standard Huffman tables of T.81 Annex K, and
// jcmarker.c's markers (JFIF 1.01 APP0, DQT, SOF0, DHT, SOS). Written from
// ITU-T T.81 and those files.
//
// Grey (one channel) or BGR (three) input, 8-bit; 4:4:4 or 4:2:0 chroma.
// Four channels are CMYK samples written as libjpeg writes a JCS_CMYK
// image (PIL's CMYK JPEG): no colour conversion, every component on table
// 0, an Adobe APP14 marker (transform 0) in place of JFIF, 4:4:4.
//
// C interface, safe to call from several threads at once: it fills
// caller-owned memory, returns 0 on success and otherwise an error code
// with a message in `err`. Nothing aborts.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Fail {
  char msg[200];
};

[[noreturn]] void fail(const char* fmt, long a = 0, long b = 0) {
  Fail f;
  std::snprintf(f.msg, sizeof(f.msg), fmt, a, b);
  throw f;
}

// natural (row-major) index of each zigzag position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order)
const int kBaseQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// jstdhuff.c: the code counts of lengths 1-16 and the symbols of each table
const uint8_t kBitsDcLum[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChr[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLum[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kValsAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChr[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kValsAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
};
const HuffSpec kDcSpec[2] = {{kBitsDcLum, kValsDc, 12}, {kBitsDcChr, kValsDc, 12}};
const HuffSpec kAcSpec[2] = {{kBitsAcLum, kValsAcLum, 162}, {kBitsAcChr, kValsAcChr, 162}};

// jchuff.c jpeg_make_c_derived_tbl: the code and its length for each symbol
struct HuffCodes {
  uint32_t code[256];
  int size[256];
  explicit HuffCodes(const HuffSpec& s) {
    std::memset(size, 0, sizeof(size));
    std::memset(code, 0, sizeof(code));
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < s.bits[l - 1]; i++, p++) {
        code[s.vals[p]] = c++;
        size[s.vals[p]] = l;
      }
      c <<= 1;
    }
  }
};

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table with force_baseline
void scaled_quant(int quality, int which, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (kBaseQuant[which][i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = static_cast<uint16_t>(t);
  }
}

// jcdctmgr.c compute_reciprocal for 16-bit DCTELEM: quantize() divides by
// `divisor` as (|x| + corr) * recip >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jfdctint.c jpeg_fdct_islow, in place; the output is scaled up by 8
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

void fdct_islow(int* data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;     // along a row, then down a column
    const int advance = pass == 0 ? 8 : 1;  // next row, then next column
    const int even_sh = pass == 0 ? 0 : kPass1Bits;
    const int odd_sh = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int ctr = 0; ctr < 8; ctr++) {
      int* p = data + ctr * advance;
      auto at = [&](int k) -> int& { return p[k * step]; };
      int64_t tmp0 = at(0) + at(7), tmp7 = at(0) - at(7);
      int64_t tmp1 = at(1) + at(6), tmp6 = at(1) - at(6);
      int64_t tmp2 = at(2) + at(5), tmp5 = at(2) - at(5);
      int64_t tmp3 = at(3) + at(4), tmp4 = at(3) - at(4);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        at(0) = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
        at(4) = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        at(0) = static_cast<int>(descale(tmp10 + tmp11, even_sh));
        at(4) = static_cast<int>(descale(tmp10 - tmp11, even_sh));
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      at(2) = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, odd_sh));
      at(6) = static_cast<int>(descale(z1 + tmp12 * (-FIX_1_847759065), odd_sh));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      at(7) = static_cast<int>(descale(tmp4 + z1 + z3, odd_sh));
      at(5) = static_cast<int>(descale(tmp5 + z2 + z4, odd_sh));
      at(3) = static_cast<int>(descale(tmp6 + z2 + z3, odd_sh));
      at(1) = static_cast<int>(descale(tmp7 + z1 + z4, odd_sh));
    }
  }
}

// jccolor.c rgb_ycc_start: SCALEBITS 16, Cb and Cr rounded by 0.5 - epsilon
struct YccTable {
  int64_t t[8][256];
  YccTable() {
    const int64_t one_half = int64_t(1) << 15, cbcr_offset = int64_t(128) << 16;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + one_half;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      t[5][i] = fix(0.50000) * i + cbcr_offset + one_half - 1;  // B->Cb, and R->Cr
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
};
const YccTable kYcc;

// the entropy-coded segment with its FF 00 stuffing
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((uint64_t(1) << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t byte = static_cast<uint8_t>(buf >> (nbits - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  // jchuff.c flush_bits: the partial byte filled with ones
  void flush() {
    if (nbits > 0) put(0x7F, 8 - nbits);
  }
};

struct Comp {
  int id, h, v, tq;
  int w, hgt;      // samples (downsampled size)
  int wib, hib;    // real blocks across and down
  std::vector<uint8_t> plane;  // wib*8 x hib*8 samples, edges expanded
};

struct Encoder {
  const uint8_t* img;
  int width, height, channels;
  int ncomp = 1, hmax = 1, vmax = 1;
  Comp comp[4];
  uint16_t quant[2][64];

  Encoder(const uint8_t* pixels, int w, int h, int c)
      : img(pixels), width(w), height(h), channels(c) {}

  // one full-resolution sample of component `c` (0 Y, 1 Cb, 2 Cr) at a
  // pixel clamped into the image: what edge expansion replicates
  int sample(int c, int x, int y) const {
    if (x >= width) x = width - 1;
    if (y >= height) y = height - 1;
    const uint8_t* px = img + (size_t(y) * width + x) * channels;
    if (channels == 1) return px[0];
    if (channels == 4) return px[c];  // jccolor.c null_convert
    const int b = px[0], g = px[1], r = px[2];
    const auto& t = kYcc.t;
    int64_t v;
    if (c == 0) v = t[0][r] + t[1][g] + t[2][b];
    else if (c == 1) v = t[3][r] + t[4][g] + t[5][b];
    else v = t[5][r] + t[6][g] + t[7][b];
    return static_cast<int>(v >> 16);
  }

  void planes() {
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      const int pw = c.wib * 8, ph = c.hib * 8;
      c.plane.resize(size_t(pw) * ph);
      const int he = hmax / c.h, ve = vmax / c.v;
      // jcsample.c h2v2_downsample: the rows a row group gives, then the
      // last one replicated down to the block (jcprepct.c expand_bottom_edge)
      const int rows = (height + ve - 1) / ve;
      for (int y = 0; y < ph; y++) {
        const int sy = y < rows ? y : rows - 1;
        uint8_t* o = c.plane.data() + size_t(y) * pw;
        for (int x = 0; x < pw; x++) {
          if (he == 1 && ve == 1) {
            o[x] = static_cast<uint8_t>(sample(i, x, sy));
          } else {  // 2x2: the bias alternates 1, 2 along the row
            int s = sample(i, 2 * x, 2 * sy) + sample(i, 2 * x + 1, 2 * sy) +
                    sample(i, 2 * x, 2 * sy + 1) + sample(i, 2 * x + 1, 2 * sy + 1);
            o[x] = static_cast<uint8_t>((s + (x & 1 ? 2 : 1)) >> 2);
          }
        }
      }
    }
  }

  // the quantised coefficients of one real block, natural order
  void block(const Comp& c, int bx, int by, const Divisor* div, int* coef) const {
    int ws[64];
    const int pw = c.wib * 8;
    for (int r = 0; r < 8; r++)
      for (int k = 0; k < 8; k++)
        ws[r * 8 + k] = c.plane[size_t(by * 8 + r) * pw + bx * 8 + k] - 128;
    fdct_islow(ws);
    for (int i = 0; i < 64; i++) {  // jcdctmgr.c quantize
      int t = ws[i];
      bool neg = t < 0;
      uint32_t a = static_cast<uint32_t>(neg ? -t : t);
      uint32_t q = static_cast<uint32_t>((uint64_t(a + div[i].corr) * div[i].recip) >> div[i].shift);
      coef[i] = neg ? -static_cast<int>(q) : static_cast<int>(q);
    }
  }

  static void encode_block(BitWriter& bw, const int* coef, int& last_dc, const HuffCodes& dc,
                           const HuffCodes& ac) {
    int temp = coef[0] - last_dc, temp2 = temp;
    last_dc = coef[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    bw.put(dc.code[nbits], dc.size[nbits]);
    if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      temp = coef[kNatural[k]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(ac.code[0xF0], ac.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      int sym = (r << 4) + nbits;
      bw.put(ac.code[sym], ac.size[sym]);
      bw.put(static_cast<uint32_t>(temp2), nbits);
      r = 0;
    }
    if (r > 0) bw.put(ac.code[0], ac.size[0]);
  }

  std::vector<uint8_t> run(int quality, bool subsample) {
    ncomp = channels;
    const bool cmyk = ncomp == 4;
    const int ysamp = (ncomp == 3 && subsample) ? 2 : 1;
    hmax = vmax = ysamp;
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = cmyk ? "CMYK"[i] : i + 1;  // jcparam.c jpeg_set_colorspace
      c.h = c.v = i == 0 ? ysamp : 1;
      c.tq = i == 0 || cmyk ? 0 : 1;
      c.w = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.hgt = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      c.wib = (c.w + 7) / 8;
      c.hib = (c.hgt + 7) / 8;
    }
    scaled_quant(quality, 0, quant[0]);
    scaled_quant(quality, 1, quant[1]);
    planes();

    std::vector<uint8_t> out;
    auto b2 = [&](int v) {
      out.push_back(static_cast<uint8_t>(v >> 8));
      out.push_back(static_cast<uint8_t>(v));
    };
    out.insert(out.end(), {0xFF, 0xD8});
    if (cmyk) {  // jcmarker.c emit_adobe_app14: version 100, no flags, transform 0
      out.insert(out.end(), {0xFF, 0xEE, 0x00, 0x0E, 'A', 'd', 'o', 'b', 'e', 0x00, 0x64, 0x00,
                             0x00, 0x00, 0x00, 0x00});
    } else {  // jcmarker.c emit_jfif_app0: version 1.01, no units, density 1:1
      out.insert(out.end(), {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01, 0x00,
                             0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
    }
    const int ntables = ncomp == 3 ? 2 : 1;
    for (int t = 0; t < ntables; t++) {
      out.insert(out.end(), {0xFF, 0xDB});
      b2(67);
      out.push_back(static_cast<uint8_t>(t));
      for (int k = 0; k < 64; k++) out.push_back(static_cast<uint8_t>(quant[t][kNatural[k]]));
    }
    out.insert(out.end(), {0xFF, 0xC0});
    b2(8 + 3 * ncomp);
    out.push_back(8);
    b2(height);
    b2(width);
    out.push_back(static_cast<uint8_t>(ncomp));
    for (int i = 0; i < ncomp; i++) {
      out.push_back(static_cast<uint8_t>(comp[i].id));
      out.push_back(static_cast<uint8_t>((comp[i].h << 4) | comp[i].v));
      out.push_back(static_cast<uint8_t>(comp[i].tq));
    }
    for (int t = 0; t < ntables; t++) {
      for (int cls = 0; cls < 2; cls++) {
        const HuffSpec& s = cls == 0 ? kDcSpec[t] : kAcSpec[t];
        out.insert(out.end(), {0xFF, 0xC4});
        b2(2 + 1 + 16 + s.nvals);
        out.push_back(static_cast<uint8_t>((cls << 4) | t));
        out.insert(out.end(), s.bits, s.bits + 16);
        out.insert(out.end(), s.vals, s.vals + s.nvals);
      }
    }
    out.insert(out.end(), {0xFF, 0xDA});
    b2(6 + 2 * ncomp);
    out.push_back(static_cast<uint8_t>(ncomp));
    for (int i = 0; i < ncomp; i++) {
      out.push_back(static_cast<uint8_t>(comp[i].id));
      out.push_back(static_cast<uint8_t>(comp[i].tq == 0 ? 0x00 : 0x11));
    }
    out.insert(out.end(), {0x00, 0x3F, 0x00});

    const HuffCodes dc[2] = {HuffCodes(kDcSpec[0]), HuffCodes(kDcSpec[1])};
    const HuffCodes ac[2] = {HuffCodes(kAcSpec[0]), HuffCodes(kAcSpec[1])};
    Divisor div[2][64];
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) div[t][i] = reciprocal(uint32_t(quant[t][i]) << 3);

    BitWriter bw(out);
    int last_dc[4] = {0, 0, 0, 0};
    const int mcux = ncomp == 1 ? comp[0].wib : (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = ncomp == 1 ? comp[0].hib : (height + 8 * vmax - 1) / (8 * vmax);
    int coef[4][64];  // one block row of a component's MCU, for the dummy DCs
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (int i = 0; i < ncomp; i++) {
          const Comp& c = comp[i];
          int prev_dc = 0;
          for (int yb = 0; yb < c.v; yb++) {
            const int by = my * c.v + yb;
            for (int xb = 0; xb < c.h; xb++) {
              const int bx = mx * c.h + xb;
              int* cf = coef[xb];
              if (by < c.hib && bx < c.wib) {
                block(c, bx, by, div[c.tq], cf);
              } else {
                // jccoefct.c: a dummy block is zero but for the DC of the
                // block before it (at the bottom, the row above's last)
                std::memset(cf, 0, sizeof(int) * 64);
                cf[0] = by < c.hib ? coef[xb - 1][0] : prev_dc;
              }
              encode_block(bw, cf, last_dc[i], dc[c.tq], ac[c.tq]);
            }
            prev_dc = coef[c.h - 1][0];
          }
        }
    bw.flush();
    out.insert(out.end(), {0xFF, 0xD9});
    return out;
  }
};

}  // namespace

extern "C" {

// The most bytes yolov6_jpeg_encode can write for a width x height image.
size_t yolov6_jpeg_encode_bound(int width, int height) {
  // 4:4:4 worst case: 3 components, every block 27 + 63 * 26 bits, doubled
  // by FF stuffing, plus the headers
  size_t blocks = size_t((width + 15) / 8 + 1) * ((height + 15) / 8 + 1) * 4;
  return blocks * 420 + 1024;
}

// Encode `img` (height x width x channels bytes, channels 1 (grey), 3
// (BGR) or 4 (CMYK samples, 4:4:4)) as a baseline JPEG at `quality` (0-100, as cv2's
// IMWRITE_JPEG_QUALITY), with 4:2:0 chroma when `subsample` is nonzero and
// 4:4:4 otherwise, into `out` (`cap` bytes); `*len` is set to the size.
int yolov6_jpeg_encode(const uint8_t* img, int width, int height, int channels, int quality,
                       int subsample, uint8_t* out, size_t cap, size_t* len, char* err,
                       int errlen) {
  try {
    if (width < 1 || height < 1 || width > 65535 || height > 65535)
      fail("a JPEG holds 1 to 65535 pixels a side, not %ldx%ld", width, height);
    if (channels != 1 && channels != 3 && channels != 4)
      fail("%ld channels; the encoder takes 1, 3 or 4", channels);
    Encoder enc(img, width, height, channels);
    std::vector<uint8_t> bytes = enc.run(quality, subsample != 0);
    if (bytes.size() > cap) fail("the output needs %ld bytes, the buffer has %ld",
                                 static_cast<long>(bytes.size()), static_cast<long>(cap));
    std::memcpy(out, bytes.data(), bytes.size());
    *len = bytes.size();
    return 0;
  } catch (const Fail& f) {
    std::snprintf(err, errlen, "%s", f.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, errlen, "out of memory encoding the JPEG");
    return 2;
  } catch (...) {
    std::snprintf(err, errlen, "internal error encoding the JPEG");
    return 3;
  }
}

}  // extern "C"
