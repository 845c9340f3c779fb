// libavcodec's integer "simple" IDCT (simple_idct_template.c, BIT_DEPTH 8),
// put or added and clamped to 8 bits: FFmpeg's MPEG-4 Part 2 decoder runs it
// on every block, and its MJPEG decoder on every block of a Motion JPEG
// frame, so the frames OpenCV's FFmpeg backend returns come from it. Shared
// by mpeg4_video.cc and jpeg_decode.cc; it must stay bit-exact with FFmpeg.
#pragma once

#include <cstddef>
#include <cstdint>

namespace yolov6_simple_idct {

// the products wrap as the C source's unsigned arithmetic does
inline uint32_t mul(int w, int x) { return uint32_t(w) * uint32_t(x); }

inline void idct_row(int16_t* row) {
  constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
                W7 = 4520, ROW_SHIFT = 11, DC_SHIFT = 3;
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t t = static_cast<int16_t>(uint16_t(uint32_t(row[0]) << DC_SHIFT));
    for (int i = 0; i < 8; i++) row[i] = t;
    return;
  }
  uint32_t a0 = mul(W4, row[0]) + (1u << (ROW_SHIFT - 1)), a1 = a0, a2 = a0, a3 = a0;
  a0 += mul(W2, row[2]) + mul(W4, row[4]) + mul(W6, row[6]);
  a1 += mul(W6, row[2]) + mul(-W4, row[4]) - mul(W2, row[6]);
  a2 += mul(-W6, row[2]) + mul(-W4, row[4]) + mul(W2, row[6]);
  a3 += mul(-W2, row[2]) + mul(W4, row[4]) - mul(W6, row[6]);
  uint32_t b0 = mul(W1, row[1]) + mul(W3, row[3]) + mul(W5, row[5]) + mul(W7, row[7]);
  uint32_t b1 = mul(W3, row[1]) + mul(-W7, row[3]) + mul(-W1, row[5]) + mul(-W5, row[7]);
  uint32_t b2 = mul(W5, row[1]) + mul(-W1, row[3]) + mul(W7, row[5]) + mul(W3, row[7]);
  uint32_t b3 = mul(W7, row[1]) + mul(-W5, row[3]) + mul(W3, row[5]) + mul(-W1, row[7]);
  row[0] = static_cast<int16_t>(int(a0 + b0) >> ROW_SHIFT);
  row[7] = static_cast<int16_t>(int(a0 - b0) >> ROW_SHIFT);
  row[1] = static_cast<int16_t>(int(a1 + b1) >> ROW_SHIFT);
  row[6] = static_cast<int16_t>(int(a1 - b1) >> ROW_SHIFT);
  row[2] = static_cast<int16_t>(int(a2 + b2) >> ROW_SHIFT);
  row[5] = static_cast<int16_t>(int(a2 - b2) >> ROW_SHIFT);
  row[3] = static_cast<int16_t>(int(a3 + b3) >> ROW_SHIFT);
  row[4] = static_cast<int16_t>(int(a3 - b3) >> ROW_SHIFT);
}

// the IDCT of `blk` (raster order, rows transformed in place) put into
// `dest`, or added to it when `add`
inline void simple_idct(int16_t* blk, uint8_t* dest, int stride, bool add) {
  constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
                W7 = 4520, COL_SHIFT = 20;
  for (int i = 0; i < 8; i++) idct_row(blk + 8 * i);
  for (int c = 0; c < 8; c++) {
    const int16_t* col = blk + c;
    uint32_t a0 = uint32_t(W4) * uint32_t(col[0] + ((1 << (COL_SHIFT - 1)) / W4));
    uint32_t a1 = a0, a2 = a0, a3 = a0;
    a0 += mul(W2, col[16]) + mul(W4, col[32]) + mul(W6, col[48]);
    a1 += mul(W6, col[16]) + mul(-W4, col[32]) + mul(-W2, col[48]);
    a2 += mul(-W6, col[16]) + mul(-W4, col[32]) + mul(W2, col[48]);
    a3 += mul(-W2, col[16]) + mul(W4, col[32]) + mul(-W6, col[48]);
    uint32_t b0 = mul(W1, col[8]) + mul(W3, col[24]) + mul(W5, col[40]) + mul(W7, col[56]);
    uint32_t b1 = mul(W3, col[8]) + mul(-W7, col[24]) + mul(-W1, col[40]) + mul(-W5, col[56]);
    uint32_t b2 = mul(W5, col[8]) + mul(-W1, col[24]) + mul(W7, col[40]) + mul(W3, col[56]);
    uint32_t b3 = mul(W7, col[8]) + mul(-W5, col[24]) + mul(W3, col[40]) + mul(-W1, col[56]);
    const int r[8] = {int(a0 + b0) >> COL_SHIFT, int(a1 + b1) >> COL_SHIFT,
                      int(a2 + b2) >> COL_SHIFT, int(a3 + b3) >> COL_SHIFT,
                      int(a3 - b3) >> COL_SHIFT, int(a2 - b2) >> COL_SHIFT,
                      int(a1 - b1) >> COL_SHIFT, int(a0 - b0) >> COL_SHIFT};
    for (int y = 0; y < 8; y++) {
      uint8_t* p = dest + size_t(y) * stride + c;
      const int v = add ? *p + r[y] : r[y];
      *p = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

}  // namespace yolov6_simple_idct
