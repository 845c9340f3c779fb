// Strip and tile codecs of the TIFF reader and writer (data/tiff.py), as
// libtiff 4.7 decodes and encodes them behind cv2.imread and cv2.imwrite:
//
// - LZW (compression 5, tif_lzw.c): MSB-first codes of 9-12 bits, Clear
//   at 256, EOI at 257, the code width growing one code early on decode;
//   the encoder is libtiff's LZWEncode, Clear when the table fills (code
//   4094) or when the compression ratio falls at a checkpoint, so that the
//   bytes equal cv2.imencode('.tif')'s. The old-style (bit-reversed) LZW
//   of libtiff's compatibility decoder is refused.
// - PackBits (32773, tif_packbits.c).
// - CCITT Group 3 (3, 1-D and 2-D, with EOLs) and Group 4 (4) fax
//   (tif_fax3.c), MSB first; the run-length codes are ITU-T T.4's, those
//   of libtiff's TIFFFaxWhiteCodes and TIFFFaxBlackCodes.
//
// C interface, safe to call from several threads at once: every function
// fills caller-owned memory, returns 0 on success and otherwise an error
// code with a message in `err`. Nothing aborts.

#include <cstdint>
#include <cstdio>
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
    std::snprintf(err, errlen, "out of memory in the TIFF codec");
    return INTERNAL;
  } catch (...) {
    std::snprintf(err, errlen, "internal error in the TIFF codec");
    return INTERNAL;
  }
}

// ------------------------------------------------------------------ LZW

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12;
constexpr int kCodeMax = (1 << kBitsMax) - 1;

size_t lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1))
    fail(UNSUPPORTED, "old-style (bit-reversed) LZW TIFF strip; the port decodes TIFF LZW only");
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  for (int i = 0; i < 256; i++) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  size_t bitpos = 0, out = 0;
  const size_t nbits_total = n * 8;
  int nbits = kBitsMin, free_ent = kFirst, old = -1;
  auto next = [&]() -> int {
    if (bitpos + nbits > nbits_total) return kEoi;  // the data ends: as an EOI
    uint32_t acc = 0;
    size_t byte = bitpos >> 3;
    for (int k = 0; k < 3 && byte + k < n; k++) acc |= uint32_t(src[byte + k]) << (16 - 8 * k);
    int code = (acc >> (24 - nbits - (bitpos & 7))) & ((1 << nbits) - 1);
    bitpos += nbits;
    return code;
  };
  while (out < want) {
    int code = next();
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = kBitsMin;
      free_ent = kFirst;
      do code = next(); while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) fail(CORRUPT, "corrupt TIFF LZW data: a code past the table after Clear");
      dst[out++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0) {  // no Clear first: libtiff takes the code as a literal too
      if (code > 255) fail(CORRUPT, "corrupt TIFF LZW data: bad first code");
      dst[out++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (code > free_ent || code == kClear || code == kEoi)
      fail(CORRUPT, "corrupt TIFF LZW data: code %ld past the table", code);
    // the new entry: old's string and the first byte of code's (or old's)
    int fc = code < free_ent ? first[code] : first[old];
    if (free_ent < 4096) {
      prefix[free_ent] = static_cast<uint16_t>(old);
      suffix[free_ent] = static_cast<uint8_t>(fc);
      first[free_ent] = first[old];
      length[free_ent] = static_cast<uint16_t>(length[old] + 1);
    }
    int len = length[code];
    size_t room = want - out;
    // write code's string backwards, clipped to the room left
    int c = code;
    for (int i = len - 1; i >= 0; i--) {
      if (size_t(i) < room) dst[out + i] = suffix[c];
      c = prefix[c];
    }
    out += size_t(len) < room ? size_t(len) : room;
    if (free_ent < 4096) free_ent++;
    if (free_ent >= (1 << nbits) - 1 && nbits < kBitsMax) nbits++;
    old = code;
  }
  return out;
}

struct BitWriter {
  uint8_t* dst;
  size_t cap, pos = 0;
  uint64_t data = 0;
  int bits = 0;
  void put(int code, int nbits) {
    data = (data << nbits) | uint64_t(code);
    bits += nbits;
    while (bits >= 8) {
      if (pos >= cap) fail(INTERNAL, "LZW output buffer too small");
      dst[pos++] = static_cast<uint8_t>(data >> (bits - 8));
      bits -= 8;
    }
  }
  void flush() {
    if (bits > 0) {
      if (pos >= cap) fail(INTERNAL, "LZW output buffer too small");
      dst[pos++] = static_cast<uint8_t>((data << (8 - bits)) & 0xFF);
      bits = 0;
    }
  }
};

// libtiff's LZWEncode over one strip: Clear first, then codes, the table
// reset when it fills or when the ratio check of every 10,000 input bytes
// finds the compression no better than at the last check; EOI at the end
size_t lzw_encode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  constexpr int kHashSize = 1 << 14;
  constexpr long kCheckGap = 10000;
  std::vector<int32_t> keys(kHashSize, -1);
  std::vector<uint16_t> codes(kHashSize);
  BitWriter w{dst, cap};
  long incount = 0, outcount = 0, checkpoint = kCheckGap, ratio = 0;
  int nbits = kBitsMin, maxcode = (1 << kBitsMin) - 1, free_ent = kFirst;
  auto put = [&](int code) {
    w.put(code, nbits);
    outcount += nbits;
  };
  auto reset = [&]() {
    std::fill(keys.begin(), keys.end(), -1);
    ratio = 0;
    incount = 0;
    outcount = 0;
    free_ent = kFirst;
    put(kClear);
    nbits = kBitsMin;
    maxcode = (1 << kBitsMin) - 1;
  };
  if (n == 0) {
    put(kEoi);
    w.flush();
    return w.pos;
  }
  put(kClear);
  int ent = src[0];
  incount = 1;
  for (size_t i = 1; i < n; i++) {
    int c = src[i];
    incount++;
    int32_t key = (int32_t(c) << 12) | ent;
    uint32_t h = (uint32_t(key) * 2654435761u) >> 18;
    while (keys[h] >= 0 && keys[h] != key) h = (h + 1) & (kHashSize - 1);
    if (keys[h] == key) {
      ent = codes[h];
      continue;
    }
    put(ent);
    ent = c;
    keys[h] = key;
    codes[h] = static_cast<uint16_t>(free_ent++);
    if (free_ent == kCodeMax - 1) {
      reset();
    } else if (free_ent > maxcode) {
      nbits++;
      maxcode = (1 << nbits) - 1;
    } else if (incount >= checkpoint) {
      checkpoint = incount + kCheckGap;
      long rat;
      if (incount > 0x007fffff) {
        rat = outcount >> 8;
        rat = rat == 0 ? 0x7fffffff : incount / rat;
      } else {
        rat = (incount << 8) / outcount;
      }
      if (rat <= ratio) reset();
      else ratio = rat;
    }
  }
  // LZWPostEncode: the last code, the width the next entry would need, EOI
  put(ent);
  free_ent++;
  if (free_ent == kCodeMax - 1) {
    put(kClear);
    nbits = kBitsMin;
  } else if (free_ent > maxcode) {
    nbits++;
  }
  put(kEoi);
  w.flush();
  return w.pos;
}

// ------------------------------------------------------------- PackBits

size_t packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  size_t i = 0, out = 0;
  while (i < n && out < want) {
    int b = static_cast<int8_t>(src[i++]);
    if (b >= 0) {
      size_t k = size_t(b) + 1;
      if (i + k > n) k = n - i;
      if (k > want - out) k = want - out;
      std::memcpy(dst + out, src + i, k);
      out += k;
      i += size_t(b) + 1;
    } else if (b != -128) {
      if (i >= n) break;
      size_t k = size_t(1 - b);
      if (k > want - out) k = want - out;
      std::memset(dst + out, src[i++], k);
      out += k;
    }
  }
  return out;
}

// ------------------------------------------------------------------ fax

// T.4's white run codes (length, code, run), as libtiff's TIFFFaxWhiteCodes
const int16_t kWhiteCodes[][3] = {
    {8, 0x35, 0}, {6, 0x7, 1}, {4, 0x7, 2}, {4, 0x8, 3}, {4, 0xb, 4}, {4, 0xc, 5},
    {4, 0xe, 6}, {4, 0xf, 7}, {5, 0x13, 8}, {5, 0x14, 9}, {5, 0x7, 10}, {5, 0x8, 11},
    {6, 0x8, 12}, {6, 0x3, 13}, {6, 0x34, 14}, {6, 0x35, 15}, {6, 0x2a, 16}, {6, 0x2b, 17},
    {7, 0x27, 18}, {7, 0xc, 19}, {7, 0x8, 20}, {7, 0x17, 21}, {7, 0x3, 22}, {7, 0x4, 23},
    {7, 0x28, 24}, {7, 0x2b, 25}, {7, 0x13, 26}, {7, 0x24, 27}, {7, 0x18, 28}, {8, 0x2, 29},
    {8, 0x3, 30}, {8, 0x1a, 31}, {8, 0x1b, 32}, {8, 0x12, 33}, {8, 0x13, 34}, {8, 0x14, 35},
    {8, 0x15, 36}, {8, 0x16, 37}, {8, 0x17, 38}, {8, 0x28, 39}, {8, 0x29, 40}, {8, 0x2a, 41},
    {8, 0x2b, 42}, {8, 0x2c, 43}, {8, 0x2d, 44}, {8, 0x4, 45}, {8, 0x5, 46}, {8, 0xa, 47},
    {8, 0xb, 48}, {8, 0x52, 49}, {8, 0x53, 50}, {8, 0x54, 51}, {8, 0x55, 52}, {8, 0x24, 53},
    {8, 0x25, 54}, {8, 0x58, 55}, {8, 0x59, 56}, {8, 0x5a, 57}, {8, 0x5b, 58}, {8, 0x4a, 59},
    {8, 0x4b, 60}, {8, 0x32, 61}, {8, 0x33, 62}, {8, 0x34, 63}, {5, 0x1b, 64}, {5, 0x12, 128},
    {6, 0x17, 192}, {7, 0x37, 256}, {8, 0x36, 320}, {8, 0x37, 384}, {8, 0x64, 448}, {8, 0x65, 512},
    {8, 0x68, 576}, {8, 0x67, 640}, {9, 0xcc, 704}, {9, 0xcd, 768}, {9, 0xd2, 832}, {9, 0xd3, 896},
    {9, 0xd4, 960}, {9, 0xd5, 1024}, {9, 0xd6, 1088}, {9, 0xd7, 1152}, {9, 0xd8, 1216}, {9, 0xd9, 1280},
    {9, 0xda, 1344}, {9, 0xdb, 1408}, {9, 0x98, 1472}, {9, 0x99, 1536}, {9, 0x9a, 1600}, {6, 0x18, 1664},
    {9, 0x9b, 1728}, {11, 0x8, 1792}, {11, 0xc, 1856}, {11, 0xd, 1920}, {12, 0x12, 1984}, {12, 0x13, 2048},
    {12, 0x14, 2112}, {12, 0x15, 2176}, {12, 0x16, 2240}, {12, 0x17, 2304}, {12, 0x1c, 2368}, {12, 0x1d, 2432},
    {12, 0x1e, 2496}, {12, 0x1f, 2560},
};

// T.4's black run codes (length, code, run), as libtiff's TIFFFaxBlackCodes
const int16_t kBlackCodes[][3] = {
    {10, 0x37, 0}, {3, 0x2, 1}, {2, 0x3, 2}, {2, 0x2, 3}, {3, 0x3, 4}, {4, 0x3, 5},
    {4, 0x2, 6}, {5, 0x3, 7}, {6, 0x5, 8}, {6, 0x4, 9}, {7, 0x4, 10}, {7, 0x5, 11},
    {7, 0x7, 12}, {8, 0x4, 13}, {8, 0x7, 14}, {9, 0x18, 15}, {10, 0x17, 16}, {10, 0x18, 17},
    {10, 0x8, 18}, {11, 0x67, 19}, {11, 0x68, 20}, {11, 0x6c, 21}, {11, 0x37, 22}, {11, 0x28, 23},
    {11, 0x17, 24}, {11, 0x18, 25}, {12, 0xca, 26}, {12, 0xcb, 27}, {12, 0xcc, 28}, {12, 0xcd, 29},
    {12, 0x68, 30}, {12, 0x69, 31}, {12, 0x6a, 32}, {12, 0x6b, 33}, {12, 0xd2, 34}, {12, 0xd3, 35},
    {12, 0xd4, 36}, {12, 0xd5, 37}, {12, 0xd6, 38}, {12, 0xd7, 39}, {12, 0x6c, 40}, {12, 0x6d, 41},
    {12, 0xda, 42}, {12, 0xdb, 43}, {12, 0x54, 44}, {12, 0x55, 45}, {12, 0x56, 46}, {12, 0x57, 47},
    {12, 0x64, 48}, {12, 0x65, 49}, {12, 0x52, 50}, {12, 0x53, 51}, {12, 0x24, 52}, {12, 0x37, 53},
    {12, 0x38, 54}, {12, 0x27, 55}, {12, 0x28, 56}, {12, 0x58, 57}, {12, 0x59, 58}, {12, 0x2b, 59},
    {12, 0x2c, 60}, {12, 0x5a, 61}, {12, 0x66, 62}, {12, 0x67, 63}, {10, 0xf, 64}, {12, 0xc8, 128},
    {12, 0xc9, 192}, {12, 0x5b, 256}, {12, 0x33, 320}, {12, 0x34, 384}, {12, 0x35, 448}, {13, 0x6c, 512},
    {13, 0x6d, 576}, {13, 0x4a, 640}, {13, 0x4b, 704}, {13, 0x4c, 768}, {13, 0x4d, 832}, {13, 0x72, 896},
    {13, 0x73, 960}, {13, 0x74, 1024}, {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216}, {13, 0x52, 1280},
    {13, 0x53, 1344}, {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5a, 1536}, {13, 0x5b, 1600}, {13, 0x64, 1664},
    {13, 0x65, 1728}, {11, 0x8, 1792}, {11, 0xc, 1856}, {11, 0xd, 1920}, {12, 0x12, 1984}, {12, 0x13, 2048},
    {12, 0x14, 2112}, {12, 0x15, 2176}, {12, 0x16, 2240}, {12, 0x17, 2304}, {12, 0x1c, 2368}, {12, 0x1d, 2432},
    {12, 0x1e, 2496}, {12, 0x1f, 2560},
};

struct FaxTable {
  // a 13-bit look-ahead -> (code length, run); run -1 where no code starts
  int8_t len[1 << 13];
  int16_t run[1 << 13];
  FaxTable(const int16_t (*codes)[3], int count) {
    std::memset(len, 0, sizeof(len));
    for (int i = 0; i < (1 << 13); i++) run[i] = -1;
    for (int k = 0; k < count; k++) {
      int l = codes[k][0], c = codes[k][1];
      int lo = c << (13 - l), hi = (c + 1) << (13 - l);
      for (int i = lo; i < hi; i++) {
        len[i] = static_cast<int8_t>(l);
        run[i] = codes[k][2];
      }
    }
  }
};

const FaxTable kWhite(kWhiteCodes, sizeof(kWhiteCodes) / sizeof(kWhiteCodes[0]));
const FaxTable kBlack(kBlackCodes, sizeof(kBlackCodes) / sizeof(kBlackCodes[0]));

struct FaxBits {
  const uint8_t* d;
  size_t nbits, pos = 0;
  bool done() const { return pos >= nbits; }
  // the next k (<= 25) bits, MSB first, zeros past the end
  uint32_t peek(int k) const {
    uint32_t acc = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 4; i++) {
      acc <<= 8;
      if (byte + i < (nbits >> 3)) acc |= d[byte + i];
    }
    return (acc << (pos & 7)) >> (32 - k);
  }
  void skip(int k) { pos += k; }
};

// one colour's run: make-up codes and the terminating code
int fax_run(FaxBits& b, bool black) {
  const FaxTable& t = black ? kBlack : kWhite;
  int total = 0;
  for (;;) {
    if (b.done()) fail(TRUNCATED, "truncated CCITT fax data in a TIFF strip");
    uint32_t ix = b.peek(13);
    int r = t.run[ix];
    if (r < 0) fail(CORRUPT, "corrupt CCITT fax data: bad run code");
    b.skip(t.len[ix]);
    total += r;
    if (r < 64) return total;
  }
}

// the row's changing elements from its runs: a0 steps, colour flips
void fill_row(const std::vector<int>& changes, int width, uint8_t* row) {
  int color = 0, x = 0;
  for (int c : changes) {
    int e = c < width ? c : width;
    if (e > x) std::memset(row + x, color, size_t(e - x));
    if (e > x) x = e;
    color ^= 1;
  }
  if (x < width) std::memset(row + x, color, size_t(width - x));
}

void fax_row_1d(FaxBits& b, int width, std::vector<int>& cur) {
  cur.clear();
  int a0 = 0;
  bool black = false;
  while (a0 < width) {
    a0 += fax_run(b, black);
    cur.push_back(a0 < width ? a0 : width);
    black = !black;
  }
}

// T.4 2-D / T.6: each mode codes a changing element of this row against
// the reference row's b1 (the first change right of a0 to the opposite
// colour) and b2 (the change after b1)
void fax_row_2d(FaxBits& b, int width, const std::vector<int>& ref, std::vector<int>& cur) {
  cur.clear();
  int a0 = -1, color = 0;  // colour 0: white
  size_t ri = 0;  // where the search for b1 starts
  while (a0 < width) {
    if (b.done()) fail(TRUNCATED, "truncated CCITT fax data in a TIFF strip");
    // b1: the first change right of a0 whose new colour is the opposite of a0's
    size_t i = ri;
    while (i > 0 && ref[i - 1] > a0) i--;
    while (i < ref.size() && (ref[i] <= a0 || int(i & 1) != color)) i++;
    ri = i;
    int b1 = i < ref.size() ? ref[i] : width;
    int b2 = i + 1 < ref.size() ? ref[i + 1] : width;
    uint32_t p = b.peek(7);
    if (p >> 6 == 1) {  // V0: 1
      b.skip(1);
      cur.push_back(b1);
      a0 = b1;
      color ^= 1;
    } else if (p >> 4 == 3 || p >> 4 == 2) {  // VR1 011, VL1 010
      b.skip(3);
      int a1 = (p >> 4 == 3) ? b1 + 1 : b1 - 1;
      cur.push_back(a1);
      a0 = a1;
      color ^= 1;
    } else if (p >> 4 == 1) {  // H: 001, two runs
      b.skip(3);
      int start = a0 < 0 ? 0 : a0;
      int a1 = start + fax_run(b, color == 1);
      int a2 = a1 + fax_run(b, color == 0);
      cur.push_back(a1);
      cur.push_back(a2);
      a0 = a2;
    } else if (p >> 3 == 1) {  // P: 0001
      b.skip(4);
      a0 = b2;
    } else if (p >> 1 == 3 || p >> 1 == 2) {  // VR2 000011, VL2 000010
      b.skip(6);
      int a1 = (p >> 1 == 3) ? b1 + 2 : b1 - 2;
      cur.push_back(a1);
      a0 = a1;
      color ^= 1;
    } else if (p == 3 || p == 2) {  // VR3 0000011, VL3 0000010
      b.skip(7);
      int a1 = (p == 3) ? b1 + 3 : b1 - 3;
      cur.push_back(a1);
      a0 = a1;
      color ^= 1;
    } else {
      fail(UNSUPPORTED, "CCITT fax data with an extension or EOL inside a row (uncompressed "
                        "mode is not decoded)");
    }
    if (a0 < 0) fail(CORRUPT, "corrupt CCITT fax data: a change left of the row");
  }
}

// libtiff's SYNC_EOL: on to 11 zero bits, past the zeros, past the 1
bool fax_sync_eol(FaxBits& b) {
  while (!b.done() && b.peek(11) != 0) b.skip(1);
  while (!b.done() && b.peek(1) == 0) b.skip(1);
  if (b.done()) return false;
  b.skip(1);
  return true;
}

void fax_decode(const uint8_t* src, size_t n, uint8_t* dst, int width, int rows, int mode,
                int t4options) {
  if (t4options & 2)
    fail(UNSUPPORTED, "Group 3 fax TIFF in uncompressed mode (T4Options bit 1) is not decoded");
  FaxBits b{src, n * 8};
  std::vector<int> ref, cur;
  for (int y = 0; y < rows; y++) {
    if (mode == 4) {
      fax_row_2d(b, width, ref, cur);
    } else {
      if (!fax_sync_eol(b)) fail(TRUNCATED, "truncated Group 3 fax data: no EOL before row %ld", y);
      bool one_d = true;
      if (t4options & 1) {  // 2-D coding: a tag bit after each EOL
        one_d = b.peek(1) == 1;
        b.skip(1);
      }
      if (one_d) fax_row_1d(b, width, cur);
      else fax_row_2d(b, width, ref, cur);
    }
    fill_row(cur, width, dst + size_t(y) * width);
    ref = cur;
  }
}

}  // namespace

extern "C" {

// LZW-decode `n` bytes of `src` into `want` bytes of `dst`; `got` is the
// number decoded (less than `want` when the codes end first).
int yolov6_tiff_lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t want, size_t* got,
                           char* err, int errlen) {
  return run(err, errlen, [&] { *got = lzw_decode(src, n, dst, want); });
}

// LZW-encode `n` bytes of `src` as one strip into `dst` (room for `cap`
// bytes; n * 3 / 2 + 16 always suffices); `got` is the encoded size.
int yolov6_tiff_lzw_encode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* got,
                           char* err, int errlen) {
  return run(err, errlen, [&] { *got = lzw_encode(src, n, dst, cap); });
}

int yolov6_tiff_packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t want,
                                size_t* got, char* err, int errlen) {
  return run(err, errlen, [&] { *got = packbits_decode(src, n, dst, want); });
}

// Decode `rows` rows of `width` pixels of Group 3 (`mode` 3, with the
// TIFF's T4Options) or Group 4 (`mode` 4) fax into `dst`, a byte a pixel:
// 0 in a white run, 1 in a black run.
int yolov6_tiff_fax_decode(const uint8_t* src, size_t n, uint8_t* dst, int width, int rows,
                           int mode, int t4options, char* err, int errlen) {
  return run(err, errlen, [&] { fax_decode(src, n, dst, width, rows, mode, t4options); });
}

}  // extern "C"
