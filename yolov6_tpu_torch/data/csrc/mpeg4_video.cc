// MPEG-4 Part 2 (ISO/IEC 14496-2) video on the host: a decoder of the
// Simple and Advanced Simple subset that FFmpeg's "mpeg4" encoder writes for
// OpenCV's VideoWriter (fourcc mp4v), bit-exact with FFmpeg's decoder as
// OpenCV's FFmpeg backend runs it, and an intra-only encoder.
//
// The decoder follows libavcodec's mpeg4videodec.c / h263dec.c /
// mpegvideo_motion.c where the standard leaves a choice: the integer "simple"
// IDCT (simple_idct_template.c, 8-bit), H.263 and MPEG quantisation as
// mpegvideo's unquantizers apply them, DC/AC prediction with its slice rules,
// median motion-vector prediction, half-pel compensation under rounding_type
// with the edge emulated at the macroblock-aligned size, and the x86 build's
// "no rounding" half-pel averages (a saturating decrement before a rounded
// average), which are what the decoder runs without AV_CODEC_FLAG_BITEXACT.
// It refuses, naming the feature: B-VOPs, S(GMC)-VOPs, quarter-pel,
// interlaced VOPs, data partitioning (and so reversible VLC), a
// non-rectangular shape, not_8_bit, newpred, reduced-resolution VOPs,
// scalability, complexity estimation headers and the studio profiles.
//
// The encoder writes VOS + VO + VOL headers and I-VOPs only, at a fixed
// quantiser (H.263 quantisation, intra DC VLC, DC prediction, no AC
// prediction): a valid MPEG-4 stream that every decoder reads.
//
// Built by the host g++ into build/host/ at first use (data/mpeg4.py) and
// called through a plain C interface.

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <utility>
#include <vector>

#include "simple_idct.h"

namespace {

// ---------------------------------------------------------------- errors

enum { OK = 0, UNSUPPORTED = 1, CORRUPT = 2, INTERNAL = 3 };

struct Fail {
  int code;
  char msg[256];
};

[[noreturn]] void fail(int code, const char* fmt, ...) {
  Fail f;
  f.code = code;
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(f.msg, sizeof f.msg, fmt, ap);
  va_end(ap);
  throw f;
}

// ---------------------------------------------------------------- tables
// ISO/IEC 14496-2 Annex B, in libavcodec's order (h263data.c, mpeg4data.h)

// intra MCBPC: 0-3 intra (cbpc), 4-7 intra+q, 8 stuffing
const uint8_t kIntraMcbpcCode[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
const uint8_t kIntraMcbpcBits[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
// inter MCBPC: 0-3 inter, 4-7 intra, 8-11 inter+q, 12-15 intra+q, 16-19
// inter4v, 20 stuffing, 24-27 inter4v+q
const uint8_t kInterMcbpcCode[28] = {1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4,
                                     3, 2, 2, 5, 4, 5, 1, 0, 0, 0, 2, 12, 14, 15};
const uint8_t kInterMcbpcBits[28] = {1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9,
                                     9, 9, 3, 7, 7, 8, 9, 0, 0, 0, 11, 13, 13, 13};
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                              {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const uint8_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF: 102 (last, run, level) codes and the escape (index 102)
const uint16_t kInterVlc[103][2] = {
    {2, 2},   {15, 4},  {21, 6},  {23, 7},  {31, 8},  {37, 9},  {36, 9},  {33, 10}, {32, 10},
    {7, 11},  {6, 11},  {32, 11}, {6, 3},   {20, 6},  {30, 8},  {15, 10}, {33, 11}, {80, 12},
    {14, 4},  {29, 8},  {14, 10}, {81, 12}, {13, 5},  {35, 9},  {13, 10}, {12, 5},  {34, 9},
    {82, 12}, {11, 5},  {12, 10}, {83, 12}, {19, 6},  {11, 10}, {84, 12}, {18, 6},  {10, 10},
    {17, 6},  {9, 10},  {16, 6},  {8, 10},  {22, 7},  {85, 12}, {21, 7},  {20, 7},  {28, 8},
    {27, 8},  {33, 9},  {32, 9},  {31, 9},  {30, 9},  {29, 9},  {28, 9},  {27, 9},  {26, 9},
    {34, 11}, {35, 11}, {86, 12}, {87, 12}, {7, 4},   {25, 9},  {5, 11},  {15, 6},  {4, 11},
    {14, 6},  {13, 6},  {12, 6},  {19, 7},  {18, 7},  {17, 7},  {16, 7},  {26, 8},  {25, 8},
    {24, 8},  {23, 8},  {22, 8},  {21, 8},  {20, 8},  {19, 8},  {24, 9},  {23, 9},  {22, 9},
    {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {7, 10},  {6, 10},  {5, 10},  {4, 10},
    {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const int8_t kInterRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2,  1,  2,  1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1,  2,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint16_t kIntraVlc[103][2] = {
    {2, 2},   {6, 3},   {15, 4},  {13, 5},  {12, 5},  {21, 6},  {19, 6},  {18, 6},  {23, 7},
    {31, 8},  {30, 8},  {29, 8},  {37, 9},  {36, 9},  {35, 9},  {33, 9},  {33, 10}, {32, 10},
    {15, 10}, {14, 10}, {7, 11},  {6, 11},  {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12},
    {14, 4},  {20, 6},  {22, 7},  {28, 8},  {32, 9},  {31, 9},  {13, 10}, {34, 11}, {83, 12},
    {85, 12}, {11, 5},  {21, 7},  {30, 9},  {12, 10}, {86, 12}, {17, 6},  {27, 8},  {29, 9},
    {11, 10}, {16, 6},  {34, 9},  {10, 10}, {13, 6},  {28, 9},  {8, 10},  {18, 7},  {27, 9},
    {84, 12}, {20, 7},  {26, 9},  {87, 12}, {25, 8},  {9, 10},  {24, 8},  {35, 11}, {23, 8},
    {25, 9},  {24, 9},  {7, 10},  {88, 12}, {7, 4},   {12, 6},  {22, 8},  {23, 9},  {6, 10},
    {5, 11},  {4, 11},  {89, 12}, {15, 6},  {22, 9},  {5, 10},  {14, 6},  {4, 10},  {17, 7},
    {36, 11}, {16, 7},  {37, 11}, {19, 7},  {90, 12}, {21, 8},  {91, 12}, {20, 8},  {19, 8},
    {26, 8},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {38, 11}, {39, 11}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4,  4,  4,  5,  5,  5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2,
    3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// raster order
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

int y_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

// ---------------------------------------------------------------- bits

struct Bits {
  const uint8_t* d = nullptr;
  size_t n = 0;    // bytes
  size_t pos = 0;  // bits
  uint32_t show(int k) const {  // 1 <= k <= 32; zeros past the end
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5; i++) v = (v << 8) | (byte + i < n ? d[byte + i] : 0);
    v <<= (pos & 7);
    return static_cast<uint32_t>((v >> (40 - k)) & ((uint64_t(1) << k) - 1));
  }
  void skip(int k) { pos += k; }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = show(k);
    pos += k;
    return v;
  }
  int get1() { return static_cast<int>(get(1)); }
  int sget(int k) {  // k-bit two's complement
    int v = static_cast<int>(get(k));
    return v >= (1 << (k - 1)) ? v - (1 << k) : v;
  }
  int64_t left() const { return int64_t(n) * 8 - int64_t(pos); }
  void marker(const char* what) {
    if (!get1()) fail(CORRUPT, "corrupt MPEG-4 video: marker bit missing in %s", what);
  }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nacc = 0;
  void put(int k, uint32_t v) {  // k <= 32
    acc = (acc << k) | (v & (k == 32 ? 0xFFFFFFFFu : (1u << k) - 1));
    nacc += k;
    while (nacc >= 8) {
      nacc -= 8;
      out.push_back(static_cast<uint8_t>(acc >> nacc));
    }
  }
  // next_start_code() stuffing: a 0 and then 1s to the byte boundary
  void stuff() {
    put(1, 0);
    if (nacc) put(8 - nacc, (1u << (8 - nacc)) - 1);
  }
  void start_code(uint8_t code) {
    put(24, 1);
    put(8, code);
  }
};

// VLC lookup over the next `bits` bits: symbol and length, length 0 = invalid
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  template <typename Code>
  void build(int n, Code code_len) {
    bits = 0;
    for (int i = 0; i < n; i++) {
      int l = code_len(i).second;
      if (l > bits) bits = l;
    }
    sym.assign(size_t(1) << bits, -1);
    len.assign(size_t(1) << bits, 0);
    for (int i = 0; i < n; i++) {
      auto cl = code_len(i);
      if (cl.second == 0) continue;
      int shift = bits - cl.second;
      uint32_t base = uint32_t(cl.first) << shift;
      for (uint32_t j = 0; j < (1u << shift); j++) {
        sym[base + j] = static_cast<int16_t>(i);
        len[base + j] = static_cast<uint8_t>(cl.second);
      }
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t v = b.show(bits);
    if (!len[v]) fail(CORRUPT, "corrupt MPEG-4 video: invalid %s code", what);
    b.skip(len[v]);
    return sym[v];
  }
};

struct RlTable {
  const uint16_t (*vlc)[2];
  const int8_t* run;
  const int8_t* level;
  int last_start;
  Vlc dec;
  int max_level[2][64];
  int max_run[2][65];
  void init() {
    dec.build(103, [&](int i) { return std::make_pair(int(vlc[i][0]), int(vlc[i][1])); });
    std::memset(max_level, 0, sizeof max_level);
    std::memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < 102; i++) {
      int last = i >= last_start, r = run[i], l = level[i];
      if (l > max_level[last][r]) max_level[last][r] = l;
      if (r > max_run[last][l]) max_run[last][l] = r;
    }
  }
};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  RlTable inter{kInterVlc, kInterRun, kInterLevel, 58, {}, {}, {}};
  RlTable intra{kIntraVlc, kIntraRun, kIntraLevel, 67, {}, {}, {}};
  Tables() {
    intra_mcbpc.build(9, [](int i) {
      return std::make_pair(int(kIntraMcbpcCode[i]), int(kIntraMcbpcBits[i]));
    });
    inter_mcbpc.build(28, [](int i) {
      return std::make_pair(int(kInterMcbpcCode[i]), int(kInterMcbpcBits[i]));
    });
    cbpy.build(16, [](int i) { return std::make_pair(int(kCbpy[i][0]), int(kCbpy[i][1])); });
    mv.build(33, [](int i) { return std::make_pair(int(kMv[i][0]), int(kMv[i][1])); });
    dc_lum.build(13, [](int i) { return std::make_pair(int(kDcLum[i][0]), int(kDcLum[i][1])); });
    dc_chrom.build(13, [](int i) {
      return std::make_pair(int(kDcChrom[i][0]), int(kDcChrom[i][1]));
    });
    inter.init();
    intra.init();
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

using yolov6_simple_idct::simple_idct;  // simple_idct.h: libavcodec's IDCT

// ---------------------------------------------------------------- pictures

struct Plane {
  int w = 0, h = 0;  // macroblock-aligned
  std::vector<uint8_t> px;
  void alloc(int w_, int h_) {
    w = w_;
    h = h_;
    px.assign(size_t(w) * h, 0);
  }
  uint8_t* at(int x, int y) { return px.data() + size_t(y) * w + x; }
  // the sample at (x, y) with the edge emulated (coordinates clamped)
  int clamped(int x, int y) const {
    x = x < 0 ? 0 : x >= w ? w - 1 : x;
    y = y < 0 ? 0 : y >= h ? h - 1 : y;
    return px[size_t(y) * w + x];
  }
};

struct Picture {
  Plane p[3];
  void alloc(int mbw, int mbh) {
    p[0].alloc(mbw * 16, mbh * 16);
    p[1].alloc(mbw * 8, mbh * 8);
    p[2].alloc(mbw * 8, mbh * 8);
  }
};

// half-pel prediction of a bw x bh block at (x, y) of `ref` (the edge
// emulated) into dest. dxy: bit 0 horizontal half, bit 1 vertical half.
// no_rnd: the rounding_type 1 averages as the x86 hpeldsp computes them
// without BITEXACT: x2 and y2 saturate one operand down by 1 before a
// rounded average (y2 decrements the block's odd rows), xy2 is exact.
void hpel(const Plane& ref, int x, int y, int dxy, bool no_rnd, int bw, int bh, uint8_t* dest,
          int stride) {
  uint8_t src[17 * 17];
  const int sw = bw + 1;
  for (int j = 0; j <= bh; j++)
    for (int i = 0; i <= bw; i++) src[j * sw + i] = static_cast<uint8_t>(ref.clamped(x + i, y + j));
  for (int j = 0; j < bh; j++) {
    uint8_t* o = dest + size_t(j) * stride;
    const uint8_t* r0 = src + j * sw;
    const uint8_t* r1 = r0 + sw;
    for (int i = 0; i < bw; i++) {
      int v;
      switch (dxy) {
        case 0:
          v = r0[i];
          break;
        case 1:
          v = no_rnd ? ((r0[i] ? r0[i] - 1 : 0) + r0[i + 1] + 1) >> 1 : (r0[i] + r0[i + 1] + 1) >> 1;
          break;
        case 2:
          if (!no_rnd) {
            v = (r0[i] + r1[i] + 1) >> 1;
          } else if (j & 1) {
            v = ((r0[i] ? r0[i] - 1 : 0) + r1[i] + 1) >> 1;
          } else {
            v = (r0[i] + (r1[i] ? r1[i] - 1 : 0) + 1) >> 1;
          }
          break;
        default:
          v = (r0[i] + r0[i + 1] + r1[i] + r1[i + 1] + (no_rnd ? 1 : 2)) >> 2;
      }
      o[i] = static_cast<uint8_t>(v);
    }
  }
}

int mid_pred(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  if (b > c) std::swap(b, c);
  if (a > b) std::swap(a, b);
  return b;
}

int h263_round_chroma(int x) {
  static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[x & 0xf] + ((x >> 3) & ~1);
}

// ---------------------------------------------------------------- decoder

enum { I_VOP = 0, P_VOP = 1, B_VOP = 2, S_VOP = 3 };

struct Vol {
  bool have = false;
  int width = 0, height = 0;
  int tinc_res = 0, tinc_bits = 1;
  bool mpeg_quant = false;
  uint16_t intra_matrix[64], inter_matrix[64];  // raster order
  bool resync = false;
  int low_delay = 1;
};

struct Decoder {
  Vol vol;
  int mbw = 0, mbh = 0;
  Picture cur, ref;
  bool have_ref = false;
  // the VOP's state
  int pict_type = I_VOP, qscale = 1, f_code = 1, dc_thr = 99;
  bool no_rnd = false;
  int resync_mb_x = 0, resync_mb_y = 0;
  bool first_slice_line = true;
  // prediction state, bordered: luma grid (2*mbh+1) x (2*mbw+2), chroma
  // (mbh+1) x (mbw+2); one left, one top and one right border column/row
  int wrap_y = 0, wrap_c = 0;
  std::vector<int16_t> dc[3];
  std::vector<int16_t> ac[3];  // 16 a block: [1..7] left column, [9..15] top row
  std::vector<int16_t> mv;     // 2 a luma block
  std::vector<int8_t> qtab;    // a macroblock's qscale
  // the macroblock being decoded
  int16_t blocks[6][64];
  int last_index[6];
  bool mb_intra = false, ac_pred = false;
  int mv_type = 0;  // 0 16x16, 1 8x8
  int mvs[4][2];

  Bits gb;

  void setup_size() {
    mbw = (vol.width + 15) / 16;
    mbh = (vol.height + 15) / 16;
    cur.alloc(mbw, mbh);
    ref.alloc(mbw, mbh);
    have_ref = false;
    wrap_y = 2 * mbw + 2;
    wrap_c = mbw + 2;
    dc[0].assign(size_t(wrap_y) * (2 * mbh + 1), 1024);
    dc[1].assign(size_t(wrap_c) * (mbh + 1), 1024);
    dc[2].assign(size_t(wrap_c) * (mbh + 1), 1024);
    for (int c = 0; c < 3; c++) ac[c].assign(dc[c].size() * 16, 0);
    mv.assign(dc[0].size() * 2, 0);
    qtab.assign(size_t(mbw) * mbh, 0);
  }

  int block_index(int n, int mb_x, int mb_y) const {
    if (n < 4) return (2 * mb_y + (n >> 1) + 1) * wrap_y + 2 * mb_x + (n & 1) + 1;
    return (mb_y + 1) * wrap_c + mb_x + 1;
  }
  int wrap(int n) const { return n < 4 ? wrap_y : wrap_c; }
  int comp(int n) const { return n < 4 ? 0 : n - 3; }

  // ------------------------------------------------ headers

  void load_matrix(uint16_t* m) {
    int last = 0, i = 0;
    for (; i < 64; i++) {
      int v = static_cast<int>(gb.get(8));
      if (v == 0) break;
      last = v;
      m[kZigzag[i]] = static_cast<uint16_t>(v);
    }
    if (i == 0) fail(CORRUPT, "corrupt MPEG-4 video: empty quantisation matrix");
    for (; i < 64; i++) m[kZigzag[i]] = static_cast<uint16_t>(last);
  }

  void parse_vol() {
    Vol v;
    gb.skip(1);  // random_accessible_vol
    int vo_type = static_cast<int>(gb.get(8));
    if (vo_type == 14 || vo_type == 15)  // Simple Studio, Core Studio
      fail(UNSUPPORTED, "MPEG-4 studio profile (video_object_type %d) is not supported", vo_type);
    int vo_ver_id = 1;
    if (gb.get1()) {
      vo_ver_id = static_cast<int>(gb.get(4));
      gb.skip(3);
    }
    int aspect = static_cast<int>(gb.get(4));
    if (aspect == 15) gb.skip(16);
    if (gb.get1()) {  // vol_control_parameters
      int chroma = static_cast<int>(gb.get(2));
      if (chroma != 1) fail(UNSUPPORTED, "MPEG-4 chroma_format %d is not supported (4:2:0 only)", chroma);
      v.low_delay = gb.get1();
      if (gb.get1()) {  // vbv_parameters
        gb.skip(15);
        gb.marker("the VBV parameters");
        gb.skip(15);
        gb.marker("the VBV parameters");
        gb.skip(15);
        gb.marker("the VBV parameters");
        gb.skip(3);
        gb.skip(11);
        gb.marker("the VBV parameters");
        gb.skip(15);
        gb.marker("the VBV parameters");
      }
    }
    int shape = static_cast<int>(gb.get(2));
    if (shape != 0)
      fail(UNSUPPORTED, "MPEG-4 non-rectangular shape (video_object_layer_shape %d) is not "
                        "supported", shape);
    gb.marker("the VOL header");
    v.tinc_res = static_cast<int>(gb.get(16));
    if (!v.tinc_res) fail(CORRUPT, "corrupt MPEG-4 video: vop_time_increment_resolution 0");
    int bits = 0;
    for (int r = v.tinc_res - 1; r > 0; r >>= 1) bits++;
    v.tinc_bits = bits < 1 ? 1 : bits;
    gb.marker("the VOL header");
    if (gb.get1()) gb.skip(v.tinc_bits);  // fixed_vop_rate
    gb.marker("the VOL header");
    v.width = static_cast<int>(gb.get(13));
    gb.marker("the VOL header");
    v.height = static_cast<int>(gb.get(13));
    gb.marker("the VOL header");
    if (!v.width || !v.height) fail(CORRUPT, "corrupt MPEG-4 video: VOL of size %dx%d", v.width, v.height);
    if (gb.get1()) fail(UNSUPPORTED, "MPEG-4 interlaced video is not supported");
    gb.skip(1);  // obmc_disable
    int sprite = static_cast<int>(vo_ver_id == 1 ? gb.get(1) : gb.get(2));
    if (sprite)
      fail(UNSUPPORTED, "MPEG-4 sprites (sprite_enable %d: static or GMC S-VOPs) are not "
                        "supported", sprite);
    if (gb.get1()) fail(UNSUPPORTED, "MPEG-4 not_8_bit video is not supported");
    v.mpeg_quant = gb.get1();
    for (int i = 0; i < 64; i++) {
      v.intra_matrix[i] = kDefaultIntraMatrix[i];
      v.inter_matrix[i] = kDefaultInterMatrix[i];
    }
    if (v.mpeg_quant) {
      if (gb.get1()) load_matrix(v.intra_matrix);
      if (gb.get1()) load_matrix(v.inter_matrix);
    }
    if (vo_ver_id != 1 && gb.get1()) fail(UNSUPPORTED, "MPEG-4 quarter-pel motion is not supported");
    if (!gb.get1()) fail(UNSUPPORTED, "MPEG-4 complexity estimation headers are not supported");
    v.resync = !gb.get1();
    if (gb.get1())
      fail(UNSUPPORTED, "MPEG-4 data partitioning (and reversible VLC) is not supported");
    if (vo_ver_id != 1) {
      if (gb.get1()) fail(UNSUPPORTED, "MPEG-4 newpred is not supported");
      if (gb.get1()) fail(UNSUPPORTED, "MPEG-4 reduced-resolution VOPs are not supported");
    }
    if (gb.get1()) fail(UNSUPPORTED, "MPEG-4 scalability is not supported");
    v.have = true;
    bool resize = !vol.have || v.width != vol.width || v.height != vol.height;
    vol = v;
    if (resize) setup_size();
  }

  // ------------------------------------------------ prediction

  int pred_dc(int n, int level, int* dir, int mb_x, int mb_y, bool encoding) {
    const int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
    const int w = wrap(n);
    int16_t* dcv = dc[comp(n)].data() + block_index(n, mb_x, mb_y);
    int a = dcv[-1], b = dcv[-1 - w], c = dcv[-w];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_mb_x) b = a = 1024;
    }
    if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    int ret;
    if (encoding) {
      ret = level - pred;
    } else {
      level += pred;
      ret = level;
    }
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    dcv[0] = static_cast<int16_t>(level);
    return ret;
  }

  void pred_ac(int16_t* block, int n, int dir, int mb_x, int mb_y) {
    int16_t* acv = ac[comp(n)].data() + size_t(block_index(n, mb_x, mb_y)) * 16;
    if (ac_pred) {
      if (dir == 0) {  // left
        const int16_t* l = acv - 16;
        int q = mb_x ? qtab[size_t(mb_y) * mbw + mb_x - 1] : qscale;
        if (mb_x == 0 || qscale == q || n == 1 || n == 3) {
          for (int i = 1; i < 8; i++) block[i << 3] = static_cast<int16_t>(block[i << 3] + l[i]);
        } else {
          for (int i = 1; i < 8; i++)
            block[i << 3] = static_cast<int16_t>(block[i << 3] + rounded_div(l[i] * q, qscale));
        }
      } else {  // top
        const int16_t* t = acv - size_t(16) * wrap(n);
        int q = mb_y ? qtab[size_t(mb_y - 1) * mbw + mb_x] : qscale;
        if (mb_y == 0 || qscale == q || n == 2 || n == 3) {
          for (int i = 1; i < 8; i++) block[i] = static_cast<int16_t>(block[i] + t[i + 8]);
        } else {
          for (int i = 1; i < 8; i++)
            block[i] = static_cast<int16_t>(block[i] + rounded_div(t[i + 8] * q, qscale));
        }
      }
    }
    for (int i = 1; i < 8; i++) acv[i] = block[i << 3];
    for (int i = 1; i < 8; i++) acv[8 + i] = block[i];
  }

  static int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

  // ff_h263_pred_motion, h263_pred set
  void pred_motion(int block, int mb_x, int mb_y, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    const int w = wrap_y;
    int16_t* mv0 = mv.data() + size_t(block_index(block, mb_x, mb_y)) * 2;
    const int16_t* A = mv0 - 2;
    if (first_slice_line && block < 3) {
      if (block == 0) {
        if (mb_x == resync_mb_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_mb_x) {
          const int16_t* C = mv0 + 2 * (off[block] - w);
          if (mb_x == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid_pred(A[0], 0, C[0]);
            *py = mid_pred(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (block == 1) {
        if (mb_x + 1 == resync_mb_x) {
          const int16_t* C = mv0 + 2 * (off[block] - w);
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        const int16_t* B = mv0 - 2 * w;
        const int16_t* C = mv0 + 2 * (off[block] - w);
        int a0 = A[0], a1 = A[1];
        if (mb_x == resync_mb_x) a0 = a1 = 0;
        *px = mid_pred(a0, B[0], C[0]);
        *py = mid_pred(a1, B[1], C[1]);
      }
    } else {
      const int16_t* B = mv0 - 2 * w;
      const int16_t* C = mv0 + 2 * (off[block] - w);
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
  }

  int decode_motion(int pred) {
    const Tables& t = tables();
    int code = t.mv.read(gb, "motion vector");
    if (code == 0) return pred;
    int sign = gb.get1();
    int shift = f_code - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= static_cast<int>(gb.get(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f_code;  // sign_extend(val, 5 + f_code)
    val = int(uint32_t(val) << (32 - bits)) >> (32 - bits);
    return val;
  }

  // ------------------------------------------------ blocks

  int decode_dc(int n, int* dir, int mb_x, int mb_y) {
    const Tables& t = tables();
    int code = n < 4 ? t.dc_lum.read(gb, "intra DC size") : t.dc_chrom.read(gb, "intra DC size");
    if (code > 9) fail(CORRUPT, "corrupt MPEG-4 video: intra DC size %d", code);
    int level = 0;
    if (code) {
      int v = static_cast<int>(gb.get(code));
      level = (v >> (code - 1)) ? v : v - ((1 << code) - 1);  // get_xbits
      if (code > 8) gb.marker("an intra DC");
    }
    return pred_dc(n, level, dir, mb_x, mb_y, false);
  }

  void decode_block(int16_t* block, int n, bool coded, bool intra, bool use_dc_vlc, int mb_x,
                    int mb_y) {
    const Tables& t = tables();
    const RlTable* rl;
    const uint8_t* scan = kZigzag;
    int i, qmul = 1, qadd = 0, dir = 0;
    if (intra) {
      if (use_dc_vlc) {
        block[0] = static_cast<int16_t>(decode_dc(n, &dir, mb_x, mb_y));
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, &dir, mb_x, mb_y, false);  // the direction (the DC is stored again below)
      }
      rl = &t.intra;
      if (ac_pred) scan = dir == 0 ? kAltVertical : kAltHorizontal;
    } else {
      i = -1;
      if (!coded) {
        last_index[n] = -1;
        return;
      }
      rl = &t.inter;
      if (!vol.mpeg_quant) {
        qmul = qscale << 1;
        qadd = (qscale - 1) | 1;
      }
    }
    if (coded) {
      for (;;) {
        int idx = rl->dec.read(gb, "DCT coefficient");
        int run, level, last;
        if (idx == 102) {  // escape
          if (!gb.get1()) {  // type 1: level offset
            idx = rl->dec.read(gb, "DCT coefficient");
            if (idx == 102) fail(CORRUPT, "corrupt MPEG-4 video: escape after an escape");
            last = idx >= rl->last_start;
            run = rl->run[idx];
            level = rl->level[idx] + rl->max_level[last][run];
            if (gb.get1()) level = -level;
          } else if (!gb.get1()) {  // type 2: run offset
            idx = rl->dec.read(gb, "DCT coefficient");
            if (idx == 102) fail(CORRUPT, "corrupt MPEG-4 video: escape after an escape");
            last = idx >= rl->last_start;
            level = rl->level[idx];
            run = rl->run[idx] + rl->max_run[last][level] + 1;
            if (gb.get1()) level = -level;
          } else {  // type 3: fixed length
            last = gb.get1();
            run = static_cast<int>(gb.get(6));
            gb.marker("a third escape");
            level = gb.sget(12);
            gb.marker("a third escape");
            if (level == 0) fail(CORRUPT, "corrupt MPEG-4 video: escaped level 0");
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (level < -2048) level = -2048;
            if (level > 2047) level = 2047;
            goto store;
          }
        } else {
          last = idx >= rl->last_start;
          run = rl->run[idx];
          level = rl->level[idx];
          if (gb.get1()) level = -level;
        }
        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
      store:
        i += run + 1;
        if (i > 63) fail(CORRUPT, "corrupt MPEG-4 video: DCT coefficients past the block's end");
        block[scan[i]] = static_cast<int16_t>(level);
        if (last) break;
      }
    }
    if (intra) {
      if (!use_dc_vlc) {
        block[0] = static_cast<int16_t>(pred_dc(n, block[0], &dir, mb_x, mb_y, false));
        if (i < 0) i = 0;
      }
      pred_ac(block, n, dir, mb_x, mb_y);
      if (ac_pred) i = 63;
    }
    last_index[n] = i;
  }

  // ------------------------------------------------ macroblocks

  void set_qscale(int q) { qscale = q < 1 ? 1 : q > 31 ? 31 : q; }

  void clean_intra(int mb_x, int mb_y) {
    for (int n = 0; n < 6; n++) {
      int idx = block_index(n, mb_x, mb_y);
      dc[comp(n)][idx] = 1024;
      std::memset(ac[comp(n)].data() + size_t(idx) * 16, 0, 16 * sizeof(int16_t));
    }
  }

  void set_mb_mv(int mb_x, int mb_y, int x, int y) {
    for (int n = 0; n < 4; n++) {
      int16_t* m = mv.data() + size_t(block_index(n, mb_x, mb_y)) * 2;
      m[0] = static_cast<int16_t>(x);
      m[1] = static_cast<int16_t>(y);
    }
  }

  void decode_intra_mb_body(int cbpc, int mb_x, int mb_y) {
    const Tables& t = tables();
    bool dquant = (pict_type == I_VOP) ? (cbpc & 4) : (cbpc & 8);
    mb_intra = true;
    ac_pred = gb.get1();
    int cbpy = t.cbpy.read(gb, "CBPY");
    int cbp = (cbpc & 3) | (cbpy << 2);
    bool use_dc_vlc = qscale < dc_thr;
    if (dquant) set_qscale(qscale + kDquant[gb.get(2)]);
    for (int n = 0; n < 6; n++) {
      std::memset(blocks[n], 0, sizeof blocks[n]);
      decode_block(blocks[n], n, cbp & 32, true, use_dc_vlc, mb_x, mb_y);
      cbp += cbp;
    }
    set_mb_mv(mb_x, mb_y, 0, 0);
  }

  void decode_mb(int mb_x, int mb_y) {
    const Tables& t = tables();
    mv_type = 0;
    std::memset(mvs, 0, sizeof mvs);
    if (pict_type == I_VOP) {
      int cbpc;
      do cbpc = t.intra_mcbpc.read(gb, "intra MCBPC");
      while (cbpc == 8);
      decode_intra_mb_body(cbpc, mb_x, mb_y);
      return;
    }
    int cbpc;
    do {
      if (gb.get1()) {  // not coded: 16x16 with a zero vector, no residual
        mb_intra = false;
        for (int n = 0; n < 6; n++) last_index[n] = -1;
        set_mb_mv(mb_x, mb_y, 0, 0);
        clean_intra(mb_x, mb_y);
        return;
      }
      cbpc = t.inter_mcbpc.read(gb, "inter MCBPC");
    } while (cbpc == 20);
    if (cbpc & 4) {
      decode_intra_mb_body(cbpc, mb_x, mb_y);
      return;
    }
    mb_intra = false;
    clean_intra(mb_x, mb_y);
    int cbpy = t.cbpy.read(gb, "CBPY") ^ 0xF;
    int cbp = (cbpc & 3) | (cbpy << 2);
    if (cbpc & 8) set_qscale(qscale + kDquant[gb.get(2)]);
    int px, py;
    if ((cbpc & 16) == 0) {
      pred_motion(0, mb_x, mb_y, &px, &py);
      int mx = decode_motion(px);
      int my = decode_motion(py);
      mvs[0][0] = mx;
      mvs[0][1] = my;
      set_mb_mv(mb_x, mb_y, mx, my);
    } else {
      mv_type = 1;
      for (int n = 0; n < 4; n++) {
        pred_motion(n, mb_x, mb_y, &px, &py);
        int mx = decode_motion(px);
        int my = decode_motion(py);
        mvs[n][0] = mx;
        mvs[n][1] = my;
        int16_t* m = mv.data() + size_t(block_index(n, mb_x, mb_y)) * 2;
        m[0] = static_cast<int16_t>(mx);
        m[1] = static_cast<int16_t>(my);
      }
    }
    for (int n = 0; n < 6; n++) {
      std::memset(blocks[n], 0, sizeof blocks[n]);
      decode_block(blocks[n], n, cbp & 32, false, false, mb_x, mb_y);
      cbp += cbp;
    }
  }

  // ------------------------------------------------ reconstruction

  void unquant_intra(int16_t* b, int n) {
    const int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
    b[0] = static_cast<int16_t>(b[0] * scale);
    if (!vol.mpeg_quant) {
      const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
      for (int i = 1; i < 64; i++) {
        int l = b[i];
        if (l) b[i] = static_cast<int16_t>(l < 0 ? l * qmul - qadd : l * qmul + qadd);
      }
    } else {
      const int q = qscale << 1;
      for (int i = 1; i < 64; i++) {
        int l = b[i];
        if (!l) continue;
        int a = (int)(std::abs(l) * q * vol.intra_matrix[i]) >> 4;
        b[i] = static_cast<int16_t>(l < 0 ? -a : a);
      }
    }
  }

  void unquant_inter_mpeg(int16_t* b) {
    const int q = qscale << 1;
    int sum = -1;
    for (int i = 0; i < 64; i++) {
      int l = b[i];
      if (!l) continue;
      int a = (((std::abs(l) << 1) + 1) * q * int(vol.inter_matrix[i])) >> 5;
      b[i] = static_cast<int16_t>(l < 0 ? -a : a);
      sum += l < 0 ? -a : a;
    }
    b[63] = static_cast<int16_t>(b[63] ^ (sum & 1));
  }

  uint8_t* dest(int n, int mb_x, int mb_y, int* stride) {
    if (n < 4) {
      *stride = cur.p[0].w;
      return cur.p[0].at(mb_x * 16 + (n & 1) * 8, mb_y * 16 + (n >> 1) * 8);
    }
    Plane& p = cur.p[n - 3];
    *stride = p.w;
    return p.at(mb_x * 8, mb_y * 8);
  }

  void motion(int mb_x, int mb_y) {
    const int ls = cur.p[0].w, cs = cur.p[1].w;
    uint8_t* dy = cur.p[0].at(mb_x * 16, mb_y * 16);
    uint8_t* du = cur.p[1].at(mb_x * 8, mb_y * 8);
    uint8_t* dv = cur.p[2].at(mb_x * 8, mb_y * 8);
    if (mv_type == 0) {  // mpeg_motion_internal, frame, FMT_H263
      const int mx = mvs[0][0], my = mvs[0][1];
      const int dxy = ((my & 1) << 1) | (mx & 1);
      const int src_x = mb_x * 16 + (mx >> 1), src_y = mb_y * 16 + (my >> 1);
      const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      hpel(ref.p[0], src_x, src_y, dxy, no_rnd, 16, 16, dy, ls);
      hpel(ref.p[1], src_x >> 1, src_y >> 1, uvdxy, no_rnd, 8, 8, du, cs);
      hpel(ref.p[2], src_x >> 1, src_y >> 1, uvdxy, no_rnd, 8, 8, dv, cs);
      return;
    }
    int sx = 0, sy = 0;
    for (int i = 0; i < 4; i++) {  // hpel_motion
      const int mx = mvs[i][0], my = mvs[i][1];
      int dxy = 0;
      int src_x = mb_x * 16 + (i & 1) * 8 + (mx >> 1);
      int src_y = mb_y * 16 + (i >> 1) * 8 + (my >> 1);
      src_x = src_x < -16 ? -16 : src_x > vol.width ? vol.width : src_x;
      if (src_x != vol.width) dxy |= mx & 1;
      src_y = src_y < -16 ? -16 : src_y > vol.height ? vol.height : src_y;
      if (src_y != vol.height) dxy |= (my & 1) << 1;
      hpel(ref.p[0], src_x, src_y, dxy, no_rnd, 8, 8, dy + (i & 1) * 8 + (i >> 1) * 8 * ls, ls);
      sx += mx;
      sy += my;
    }
    // chroma_4mv_motion
    int mx = h263_round_chroma(sx), my = h263_round_chroma(sy);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int src_x = mb_x * 8 + mx, src_y = mb_y * 8 + my;
    const int cw = vol.width >> 1, ch = vol.height >> 1;
    src_x = src_x < -8 ? -8 : src_x > cw ? cw : src_x;
    if (src_x == cw) dxy &= ~1;
    src_y = src_y < -8 ? -8 : src_y > ch ? ch : src_y;
    if (src_y == ch) dxy &= ~2;
    hpel(ref.p[1], src_x, src_y, dxy, no_rnd, 8, 8, du, cs);
    hpel(ref.p[2], src_x, src_y, dxy, no_rnd, 8, 8, dv, cs);
  }

  void reconstruct(int mb_x, int mb_y) {
    int stride = 0;
    if (mb_intra) {
      for (int n = 0; n < 6; n++) {
        unquant_intra(blocks[n], n);
        uint8_t* d = dest(n, mb_x, mb_y, &stride);
        simple_idct(blocks[n], d, stride, false);
      }
      return;
    }
    motion(mb_x, mb_y);
    for (int n = 0; n < 6; n++) {
      if (last_index[n] < 0) continue;
      if (vol.mpeg_quant) unquant_inter_mpeg(blocks[n]);
      uint8_t* d = dest(n, mb_x, mb_y, &stride);
      simple_idct(blocks[n], d, stride, true);
    }
  }

  // ------------------------------------------------ VOPs

  int mb_num_bits() const {
    int n = mbw * mbh - 1, b = 0;
    while (n > 0) {
      b++;
      n >>= 1;
    }
    return b < 1 ? 1 : b;
  }

  // a resync marker at the macroblock boundary: the stuffing (a 0 and 1s to
  // the byte boundary, a whole byte when aligned), then at least 16 zeros
  // (16 + f_code - 1 in a P-VOP) and a 1
  bool at_resync() const {
    int k = 8 - int(gb.pos & 7);
    if (gb.show(k) != (1u << (k - 1)) - 1) return false;
    Bits b = gb;
    b.skip(k);
    int need = pict_type == I_VOP ? 16 : 16 + f_code - 1, zeros = 0;
    while (zeros < 32 && b.left() > 0 && !b.get1()) zeros++;
    return zeros >= need && zeros < 32;
  }

  void video_packet_header(int mb_x, int mb_y) {
    int k = 8 - int(gb.pos & 7);
    gb.skip(k);
    while (!gb.get1()) {
    }
    int mb_num = static_cast<int>(gb.get(mb_num_bits()));
    if (mb_num != mb_y * mbw + mb_x)
      fail(CORRUPT, "corrupt MPEG-4 video: video packet at macroblock %d, expected %d", mb_num,
           mb_y * mbw + mb_x);
    int q = static_cast<int>(gb.get(5));
    if (!q) fail(CORRUPT, "corrupt MPEG-4 video: video packet quantiser 0");
    set_qscale(q);
    if (gb.get1()) {  // header_extension_code
      while (gb.get1()) {
      }
      gb.marker("a video packet header");
      gb.skip(vol.tinc_bits);
      gb.marker("a video packet header");
      int type = static_cast<int>(gb.get(2));
      if (type != pict_type) fail(CORRUPT, "corrupt MPEG-4 video: video packet of another VOP type");
      dc_thr = kDcThreshold[gb.get(3)];
      if (pict_type == P_VOP) {
        int fc = static_cast<int>(gb.get(3));
        if (!fc) fail(CORRUPT, "corrupt MPEG-4 video: f_code 0");
        f_code = fc;
      }
    }
    resync_mb_x = mb_x;
    resync_mb_y = mb_y;
    first_slice_line = true;
  }

  // returns 1 when a picture was decoded into cur, 0 for a VOP not coded
  int parse_vop() {
    if (!vol.have) fail(CORRUPT, "corrupt MPEG-4 video: a VOP before any VOL header");
    int type = static_cast<int>(gb.get(2));
    if (type == B_VOP) fail(UNSUPPORTED, "MPEG-4 B-VOPs (vop_coding_type B) are not supported");
    if (type == S_VOP) fail(UNSUPPORTED, "MPEG-4 S(GMC)-VOPs (vop_coding_type S) are not supported");
    while (gb.get1()) {
      if (gb.left() <= 0) fail(CORRUPT, "corrupt MPEG-4 video: VOP header past the data");
    }
    gb.marker("the VOP header");
    gb.skip(vol.tinc_bits);
    gb.marker("the VOP header");
    if (!gb.get1()) return 0;  // vop_coded 0
    if (type == P_VOP && !have_ref)
      fail(CORRUPT, "corrupt MPEG-4 video: a P-VOP without a reference picture");
    pict_type = type;
    no_rnd = type == P_VOP ? gb.get1() : false;
    dc_thr = kDcThreshold[gb.get(3)];
    int q = static_cast<int>(gb.get(5));
    if (!q) fail(CORRUPT, "corrupt MPEG-4 video: vop_quant 0");
    qscale = q;
    if (type == P_VOP) {
      f_code = static_cast<int>(gb.get(3));
      if (!f_code) fail(CORRUPT, "corrupt MPEG-4 video: vop_fcode_forward 0");
    }
    decode_picture();
    return 1;
  }

  void decode_picture() {
    for (int c = 0; c < 3; c++) {
      std::fill(dc[c].begin(), dc[c].end(), int16_t(1024));
      std::fill(ac[c].begin(), ac[c].end(), int16_t(0));
    }
    std::fill(mv.begin(), mv.end(), int16_t(0));
    resync_mb_x = resync_mb_y = 0;
    first_slice_line = true;
    for (int mb_y = 0; mb_y < mbh; mb_y++) {
      for (int mb_x = 0; mb_x < mbw; mb_x++) {
        if (vol.resync && (mb_x || mb_y) && at_resync()) video_packet_header(mb_x, mb_y);
        if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = false;
        if (gb.left() < 0) fail(CORRUPT, "corrupt MPEG-4 video: the VOP's data ended early");
        try {
          decode_mb(mb_x, mb_y);
        } catch (Fail& f) {
          size_t n = std::strlen(f.msg);
          std::snprintf(f.msg + n, sizeof f.msg - n, " (macroblock %d, %d)", mb_x, mb_y);
          throw;
        }
        reconstruct(mb_x, mb_y);
        qtab[size_t(mb_y) * mbw + mb_x] = static_cast<int8_t>(qscale);
      }
    }
  }

  // one sample (a packet): headers and at most one VOP; returns 1 with a
  // picture in cur (then made the reference), 0 without
  int decode(const uint8_t* d, size_t n) {
    int got = 0;
    size_t i = 0;
    while (i + 3 < n) {
      if (!(d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1)) {
        i++;
        continue;
      }
      const uint8_t code = d[i + 3];
      gb.d = d;
      gb.n = n;
      gb.pos = (i + 4) * 8;
      if (code >= 0x20 && code <= 0x2F) {
        parse_vol();
      } else if (code == 0xB6) {
        if (got) fail(CORRUPT, "corrupt MPEG-4 video: two VOPs in one sample (packed B-frames)");
        got = parse_vop() ? 1 : 2;
        if (got == 1) {
          std::swap(cur, ref);
          have_ref = true;
        }
        i = (gb.pos + 7) / 8;
        continue;
      } else if (code == 0xB7 || code == 0xC3 || code == 0xC4) {
        fail(UNSUPPORTED, "MPEG-4 studio profile (start code 0x%02X) is not supported", code);
      }
      i += 4;
    }
    return got;
  }
};

// ---------------------------------------------------------------- encoder

struct Encoder {
  int width, height, mbw, mbh, q, tinc_res, tinc_bits;
  std::vector<int16_t> dcv;  // luma/chroma DC predictors as the decoder keeps them
  int wrap_y, wrap_c;

  Encoder(int w, int h, int quant, int res) : width(w), height(h), q(quant), tinc_res(res) {
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    int bits = 0;
    for (int r = res - 1; r > 0; r >>= 1) bits++;
    tinc_bits = bits < 1 ? 1 : bits;
    wrap_y = 2 * mbw + 2;
    wrap_c = mbw + 2;
  }

  void headers(BitWriter& bw) const {
    bw.start_code(0xB0);  // visual_object_sequence
    bw.put(8, 0x03);      // profile_and_level: Simple Profile @ L3
    bw.start_code(0xB5);  // visual_object
    bw.put(1, 0);         // is_visual_object_identifier
    bw.put(4, 1);         // visual_object_type: video
    bw.put(1, 0);         // video_signal_type
    bw.stuff();
    bw.start_code(0x00);  // video_object
    bw.start_code(0x20);  // video_object_layer
    bw.put(1, 0);         // random_accessible_vol
    bw.put(8, 1);         // video_object_type_indication: Simple
    bw.put(1, 0);         // is_object_layer_identifier
    bw.put(4, 1);         // aspect_ratio_info: square
    bw.put(1, 0);         // vol_control_parameters
    bw.put(2, 0);         // rectangular
    bw.put(1, 1);
    bw.put(16, tinc_res);
    bw.put(1, 1);
    bw.put(1, 0);  // fixed_vop_rate
    bw.put(1, 1);
    bw.put(13, width);
    bw.put(1, 1);
    bw.put(13, height);
    bw.put(1, 1);
    bw.put(1, 0);  // interlaced
    bw.put(1, 1);  // obmc_disable
    bw.put(1, 0);  // sprite_enable
    bw.put(1, 0);  // not_8_bit
    bw.put(1, 0);  // quant_type: H.263
    bw.put(1, 1);  // complexity_estimation_disable
    bw.put(1, 1);  // resync_marker_disable
    bw.put(1, 0);  // data_partitioned
    bw.put(1, 0);  // scalability
    bw.stuff();
  }

  static void put_vlc(BitWriter& bw, const uint16_t (*vlc)[2], int idx) {
    bw.put(vlc[idx][1], vlc[idx][0]);
  }

  // the intra TCOEF index of (last, run, level), -1 where the table has none
  using CodeIndex = int16_t[2][64][28];
  static const CodeIndex& intra_code() {
    static CodeIndex idx;
    static bool init = false;
    if (!init) {
      std::memset(idx, 0xFF, sizeof idx);
      const RlTable& rl = tables().intra;
      for (int k = 0; k < 102; k++) idx[k >= rl.last_start][rl.run[k]][rl.level[k]] = int16_t(k);
      init = true;
    }
    return idx;
  }

  // one intra block's coefficients after the DC (zigzag, levels quantised)
  static void put_ac(BitWriter& bw, const int* lev) {
    const RlTable& rl = tables().intra;
    int last_nz = 0;
    for (int i = 1; i < 64; i++)
      if (lev[kZigzag[i]]) last_nz = i;
    int run = 0;
    for (int i = 1; i <= last_nz; i++) {
      int l = lev[kZigzag[i]];
      if (!l) {
        run++;
        continue;
      }
      int last = i == last_nz, a = std::abs(l);
      int idx = a <= 27 ? intra_code()[last][run][a] : -1;
      if (idx >= 0) {
        put_vlc(bw, rl.vlc, idx);
        bw.put(1, l < 0);
      } else {  // third escape
        put_vlc(bw, rl.vlc, 102);
        bw.put(2, 3);
        bw.put(1, last);
        bw.put(6, run);
        bw.put(1, 1);
        bw.put(12, uint32_t(l) & 0xFFF);
        bw.put(1, 1);
      }
      run = 0;
    }
  }

  // forward DCT (orthonormal, double precision) of an 8x8 block of samples
  static void fdct(const int* in, double* out) {
    static double c[8][8];
    static bool init = false;
    if (!init) {
      for (int k = 0; k < 8; k++)
        for (int n = 0; n < 8; n++)
          c[k][n] = (k ? std::sqrt(0.25) : std::sqrt(0.125)) * std::cos((2 * n + 1) * k * M_PI / 16);
      init = true;
    }
    double tmp[64];
    for (int y = 0; y < 8; y++)
      for (int k = 0; k < 8; k++) {
        double s = 0;
        for (int n = 0; n < 8; n++) s += c[k][n] * in[y * 8 + n];
        tmp[y * 8 + k] = s;
      }
    for (int x = 0; x < 8; x++)
      for (int k = 0; k < 8; k++) {
        double s = 0;
        for (int n = 0; n < 8; n++) s += c[k][n] * tmp[n * 8 + x];
        out[k * 8 + x] = s;
      }
  }

  // the intra DC predictor as the decoder's ff_mpeg4_pred_dc computes it
  // (one slice, no resync markers)
  int dc_diff(int n, int mb_x, int mb_y, int level, int scale) {
    int idx, wrap, base;
    if (n < 4) {
      idx = (2 * mb_y + (n >> 1) + 1) * wrap_y + 2 * mb_x + (n & 1) + 1;
      wrap = wrap_y;
      base = 0;
    } else {
      idx = (mb_y + 1) * wrap_c + mb_x + 1;
      wrap = wrap_c;
      base = (n == 4 ? 1 : 2);
    }
    int16_t* d = dcv.data() + (base == 0 ? 0 : wrap_y * (2 * mbh + 1) +
                                                   (base - 1) * wrap_c * (mbh + 1)) + idx;
    int a = d[-1], b = d[-1 - wrap], c = d[-wrap];
    if (mb_y == 0 && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == 0) b = a = 1024;
    }
    if (mb_x == 0 && mb_y == 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    int pred = std::abs(a - b) < std::abs(b - c) ? c : a;
    pred = (pred + (scale >> 1)) / scale;
    int v = level * scale;
    if (v & ~2047) v = v < 0 ? 0 : 2047;
    d[0] = static_cast<int16_t>(v);
    return level - pred;
  }

  static void put_dc(BitWriter& bw, int n, int diff) {
    int a = std::abs(diff), size = 0;
    while (a >> size) size++;
    const uint8_t (*tab)[2] = n < 4 ? kDcLum : kDcChrom;
    bw.put(tab[size][1], tab[size][0]);
    if (size) {
      bw.put(size, diff > 0 ? uint32_t(diff) : uint32_t(diff + (1 << size) - 1));
      if (size > 8) bw.put(1, 1);
    }
  }

  // an I-VOP of the planes (mb-aligned, edge-replicated) at time index t
  // (ticks of tinc_res a second), `secs` whole seconds after the last VOP's
  void vop(BitWriter& bw, const uint8_t* const* planes, const int* strides, int64_t t, int secs) {
    bw.start_code(0xB6);
    bw.put(2, I_VOP);
    for (int i = 0; i < secs; i++) bw.put(1, 1);  // modulo_time_base
    bw.put(1, 0);
    bw.put(1, 1);
    bw.put(tinc_bits, uint32_t(t % tinc_res));
    bw.put(1, 1);
    bw.put(1, 1);  // vop_coded
    bw.put(3, 0);  // intra_dc_vlc_thr: the DC VLC at every quantiser
    bw.put(5, q);
    dcv.assign(size_t(wrap_y) * (2 * mbh + 1) + size_t(2) * wrap_c * (mbh + 1), 1024);
    const int ys = y_dc_scale(q), cs = c_dc_scale(q);
    for (int mb_y = 0; mb_y < mbh; mb_y++)
      for (int mb_x = 0; mb_x < mbw; mb_x++) {
        int lev[6][64], dcl[6];
        int cbp = 0;
        for (int n = 0; n < 6; n++) {
          const int c = n < 4 ? 0 : n - 3;
          const int x0 = n < 4 ? mb_x * 16 + (n & 1) * 8 : mb_x * 8;
          const int y0 = n < 4 ? mb_y * 16 + (n >> 1) * 8 : mb_y * 8;
          int px[64];
          for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) px[y * 8 + x] = planes[c][size_t(y0 + y) * strides[c] + x0 + x];
          double f[64];
          fdct(px, f);
          const int scale = n < 4 ? ys : cs;
          int d = static_cast<int>(std::lround(f[0] / scale));
          dcl[n] = d < 0 ? 0 : d > 2047 / scale ? 2047 / scale : d;
          lev[n][0] = 0;
          bool any = false;
          for (int i = 1; i < 64; i++) {
            int l = static_cast<int>(std::fabs(f[i]) / (2 * q));  // H.263 intra: |F| / 2Q
            if (l > 2047) l = 2047;
            lev[n][i] = f[i] < 0 ? -l : l;
            any |= l != 0;
          }
          if (any) cbp |= 32 >> n;
        }
        const int cbpc = cbp & 3, cbpy = cbp >> 2;
        bw.put(kIntraMcbpcBits[cbpc], kIntraMcbpcCode[cbpc]);
        bw.put(1, 0);  // ac_pred_flag
        bw.put(kCbpy[cbpy][1], kCbpy[cbpy][0]);
        for (int n = 0; n < 6; n++) {
          put_dc(bw, n, dc_diff(n, mb_x, mb_y, dcl[n], n < 4 ? ys : cs));
          if (cbp & (32 >> n)) put_ac(bw, lev[n]);
        }
      }
    bw.stuff();
  }
};

// ---------------------------------------------------------------- colour

// BT.601 YUV (chroma subsampled by sx, sy in {1, 2}) to BGR as swscale's
// unscaled x86 converter computes it for OpenCV: samples scaled by 8, the
// 13-bit coefficients multiplied high (pmulhw), summed, saturated
void yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int w, int h, int cw,
                int sx, int sy, const int* k, uint8_t* out) {
  const int yc = k[0], vr = k[1], ug = k[2], vg = k[3], ub = k[4], yo = k[5];
  for (int j = 0; j < h; j++) {
    const uint8_t* yr = y + size_t(j) * w;
    const uint8_t* ur = u + size_t(j / sy) * cw;
    const uint8_t* vr_ = v + size_t(j / sy) * cw;
    uint8_t* o = out + size_t(j) * w * 3;
    for (int i = 0; i < w; i++) {
      const int uu = (ur[i / sx] << 3) - 1024, vv = (vr_[i / sx] << 3) - 1024;
      const int yy = (((yr[i] << 3) - yo) * yc) >> 16;
      o[3 * i] = clip8(yy + ((uu * ub) >> 16));
      o[3 * i + 1] = clip8(yy + ((uu * ug) >> 16) + ((vv * vg) >> 16));
      o[3 * i + 2] = clip8(yy + ((vv * vr) >> 16));
    }
  }
}

// BGR to BT.601 limited-range 4:2:0: Y of each pixel, Cb/Cr of each 2x2
// block's mean colour (the edge repeated for an odd size), rounded
void bgr_to_yuv420(const uint8_t* bgr, int w, int h, uint8_t* y, uint8_t* u, uint8_t* v) {
  auto px = [&](int i, int j) { return bgr + (size_t(j) * w + i) * 3; };
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++) {
      const uint8_t* p = px(i, j);
      y[size_t(j) * w + i] =
          clip8(int(std::lround(16 + (65.481 * p[2] + 128.553 * p[1] + 24.966 * p[0]) / 255)));
    }
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int j = 0; j < ch; j++)
    for (int i = 0; i < cw; i++) {
      double b = 0, g = 0, r = 0;
      for (int dj = 0; dj < 2; dj++)
        for (int di = 0; di < 2; di++) {
          const uint8_t* p = px(std::min(2 * i + di, w - 1), std::min(2 * j + dj, h - 1));
          b += p[0];
          g += p[1];
          r += p[2];
        }
      b /= 4;
      g /= 4;
      r /= 4;
      u[size_t(j) * cw + i] = clip8(int(std::lround(128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255)));
      v[size_t(j) * cw + i] = clip8(int(std::lround(128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255)));
    }
}

// ---------------------------------------------------------------- C glue

template <typename Body>
int run_guarded(char* err, int errlen, Body&& body) {
  try {
    body();
    return OK;
  } catch (const Fail& f) {
    std::snprintf(err, errlen, "%s", f.msg);
    return f.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, errlen, "out of memory in the MPEG-4 codec");
    return INTERNAL;
  } catch (...) {
    std::snprintf(err, errlen, "internal error in the MPEG-4 codec");
    return INTERNAL;
  }
}

}  // namespace

extern "C" {

void* yolov6_m4v_open() {
  try {
    tables();
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void yolov6_m4v_close(void* h) { delete static_cast<Decoder*>(h); }

// headers only (the esds or CodecPrivate decoder configuration): a VOL sets
// the size; returns 0 or an error code with `err` set
int yolov6_m4v_config(void* h, const uint8_t* data, size_t n, int* width, int* height, char* err,
                      int errlen) {
  Decoder& d = *static_cast<Decoder*>(h);
  return run_guarded(err, errlen, [&] {
    if (d.decode(data, n)) fail(CORRUPT, "corrupt MPEG-4 video: a VOP in the decoder configuration");
    *width = d.vol.have ? d.vol.width : 0;
    *height = d.vol.have ? d.vol.height : 0;
  });
}

// one sample: *got = 1 when it held a coded VOP, whose picture (width x
// height, set from the VOL) yolov6_m4v_picture then copies out; 0 without
int yolov6_m4v_decode(void* h, const uint8_t* data, size_t n, int* got, int* width, int* height,
                      char* err, int errlen) {
  Decoder& d = *static_cast<Decoder*>(h);
  return run_guarded(err, errlen, [&] {
    *got = d.decode(data, n) == 1;
    *width = d.vol.have ? d.vol.width : 0;
    *height = d.vol.have ? d.vol.height : 0;
  });
}

// the last decoded picture into y (width x height), u and v ((width + 1) /
// 2 x (height + 1) / 2), at the size yolov6_m4v_decode returned
void yolov6_m4v_picture(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
  const Decoder& d = *static_cast<Decoder*>(h);
  const Picture& p = d.ref;  // the decoded picture is the next one's reference
  const int width = d.vol.width, height = d.vol.height;
  const int cw = (width + 1) / 2, ch = (height + 1) / 2;
  for (int j = 0; j < height; j++)
    std::memcpy(y + size_t(j) * width, &p.p[0].px[size_t(j) * p.p[0].w], width);
  for (int j = 0; j < ch; j++) {
    std::memcpy(u + size_t(j) * cw, &p.p[1].px[size_t(j) * p.p[1].w], cw);
    std::memcpy(v + size_t(j) * cw, &p.p[2].px[size_t(j) * p.p[2].w], cw);
  }
}

// the VOS + VO + VOL headers of the encoder's stream into out (cap bytes);
// returns the length, or -1 when out is too small
int yolov6_m4v_encode_headers(int width, int height, int tinc_res, uint8_t* out, int cap) {
  Encoder e(width, height, 2, tinc_res);
  BitWriter bw;
  e.headers(bw);
  if (int(bw.out.size()) > cap) return -1;
  std::memcpy(out, bw.out.data(), bw.out.size());
  return static_cast<int>(bw.out.size());
}

// an I-VOP of the YUV 4:2:0 planes (y: width x height, u and v: (width + 1)
// / 2 x (height + 1) / 2, edge-replicated here to macroblocks) at quantiser
// q (1-31) and time index t of tinc_res a second, `secs` whole seconds after
// the previous VOP's (its modulo_time_base); returns the length, or a
// negative number when out (cap bytes) is too small
int yolov6_m4v_encode_vop(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width,
                          int height, int q, int tinc_res, int64_t t, int secs, uint8_t* out,
                          int64_t cap) {
  try {
    Encoder e(width, height, q, tinc_res);
    const int cw = (width + 1) / 2, ch = (height + 1) / 2;
    const int src_w[3] = {width, cw, cw}, src_h[3] = {height, ch, ch};
    const uint8_t* src[3] = {y, u, v};
    std::vector<uint8_t> pl[3];
    const uint8_t* planes[3];
    int strides[3];
    for (int c = 0; c < 3; c++) {
      const int pw = c ? e.mbw * 8 : e.mbw * 16, ph = c ? e.mbh * 8 : e.mbh * 16;
      pl[c].resize(size_t(pw) * ph);
      for (int j = 0; j < ph; j++) {
        const uint8_t* r = src[c] + size_t(j < src_h[c] ? j : src_h[c] - 1) * src_w[c];
        uint8_t* o = pl[c].data() + size_t(j) * pw;
        for (int i = 0; i < pw; i++) o[i] = r[i < src_w[c] ? i : src_w[c] - 1];
      }
      planes[c] = pl[c].data();
      strides[c] = pw;
    }
    BitWriter bw;
    e.vop(bw, planes, strides, t, secs);
    if (int64_t(bw.out.size()) > cap) return -1;
    std::memcpy(out, bw.out.data(), bw.out.size());
    return static_cast<int>(bw.out.size());
  } catch (...) {
    return -2;
  }
}

// YUV planes (chroma cw wide, subsampled by sx, sy) to BGR, height x width
// x 3, with the converter's six coefficients k (data/video.py)
void yolov6_yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width,
                       int height, int cw, int sx, int sy, const int* k, uint8_t* out) {
  yuv_to_bgr(y, u, v, width, height, cw, sx, sy, k, out);
}

// BGR, height x width x 3, to 4:2:0 planes (u, v: (width + 1) / 2 x
// (height + 1) / 2)
void yolov6_bgr_to_yuv420(const uint8_t* bgr, int width, int height, uint8_t* y, uint8_t* u,
                          uint8_t* v) {
  bgr_to_yuv420(bgr, width, height, y, u, v);
}

}  // extern "C"
