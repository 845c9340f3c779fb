// Host-side training augmentation for the PyTorch port (its own copy of
// yolov6_tpu/native/train_aug.cc and of yolov6_letterbox in
// yolov6_tpu/native/preprocess.cc). C++ standard library only; built by
// data/native_aug.py with the host g++ and called through ctypes.
//
//   yolov6_train_aug  the mosaic compose, the inverse-affine bilinear warp and
//                     the flips in one pass over the output pixels: the 2Hx2W
//                     mosaic canvas is never materialised, each output pixel
//                     maps back into one of the source images;
//   yolov6_blend      the mixup blend, a = trunc(a*r + b*(1-r));
//   yolov6_letterbox  aspect-keeping bilinear resize and constant pad, the
//                     non-mosaic branch's letterbox.
//
// Every random parameter (mosaic centre, affine matrix, flips) is drawn by
// the caller; the HSV jitter runs after this pass, in numpy
// (data/data_augment.py::augment_hsv_rgb). data/native_aug.py keeps a numpy
// version of the warp and the blend as the tests' oracle.
//
// The JAX package builds its copy with -O3 -march=native, under which GCC
// fuses the interpolation's multiply-adds into FMAs. This copy writes those
// FMAs out (std::fma), builds with -ffp-contract=off so that no others
// appear, and so rounds as the JAX package's library does on any machine.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Region {
  int x1a, y1a, x2a, y2a;  // canvas box the source patch covers
  int dx, dy;              // canvas -> source offset: src(x - dx, y - dy)
  const uint8_t* src;
  int h, w;
};

// Value of the (virtual) mosaic canvas at integer coords. Points outside
// every region read the pad value, as bilinear over a canvas prefilled with
// the pad would.
inline void CanvasPx(const Region* regs, int n_regions, int ix, int iy,
                     uint8_t pad, uint8_t out[3]) {
  for (int i = 0; i < n_regions; ++i) {
    const Region& r = regs[i];
    if (ix >= r.x1a && ix < r.x2a && iy >= r.y1a && iy < r.y2a) {
      const uint8_t* p =
          r.src + (static_cast<size_t>(iy - r.dy) * r.w + (ix - r.dx)) * 3;
      out[0] = p[0];
      out[1] = p[1];
      out[2] = p[2];
      return;
    }
  }
  out[0] = out[1] = out[2] = pad;
}

}  // namespace

extern "C" {

// Mosaic + affine + flips producing out[out_h, out_w, 3] u8.
//
//   srcs/src_hw : n_regions (1..8) source images (u8, HxWx3) and their (h, w)
//   place       : per region (x1a, y1a, x2a, y2a, x1b, y1b), the mosaic
//                 placement rectangles; one region (0, 0, w, h, 0, 0) for a
//                 plain single-image affine pass
//   minv        : 6 doubles, the inverse affine (dst pixel -> canvas coords)
//   flip_lr/ud  : mirror the output (the caller flips the labels)
// Returns 0, or -1 when n_regions is outside 1..8.
int yolov6_train_aug(const uint8_t* const* srcs, const int* src_hw,
                     const int* place, int n_regions, const double* minv,
                     uint8_t* out, int out_h, int out_w, int flip_lr,
                     int flip_ud, uint8_t pad) {
  if (n_regions < 1 || n_regions > 8) return -1;
  Region regs[8];
  const int nr = n_regions;
  for (int i = 0; i < nr; ++i) {
    regs[i].x1a = place[i * 6 + 0];
    regs[i].y1a = place[i * 6 + 1];
    regs[i].x2a = place[i * 6 + 2];
    regs[i].y2a = place[i * 6 + 3];
    regs[i].dx = place[i * 6 + 0] - place[i * 6 + 4];  // x1a - x1b
    regs[i].dy = place[i * 6 + 1] - place[i * 6 + 5];  // y1a - y1b
    regs[i].src = srcs[i];
    regs[i].h = src_hw[i * 2];
    regs[i].w = src_hw[i * 2 + 1];
  }
  const float m0 = static_cast<float>(minv[0]), m1 = static_cast<float>(minv[1]),
              m2 = static_cast<float>(minv[2]), m3 = static_cast<float>(minv[3]),
              m4 = static_cast<float>(minv[4]), m5 = static_cast<float>(minv[5]);

  // union bounding box of all regions: a 2x2 block fully outside it is all
  // pad, which skips the per-neighbour region scans for the pad margins
  int ux1 = 1 << 30, uy1 = 1 << 30, ux2 = -(1 << 30), uy2 = -(1 << 30);
  for (int i = 0; i < nr; ++i) {
    ux1 = std::min(ux1, regs[i].x1a);
    uy1 = std::min(uy1, regs[i].y1a);
    ux2 = std::max(ux2, regs[i].x2a);
    uy2 = std::max(uy2, regs[i].y2a);
  }

  const Region* last = &regs[0];
  for (int y = 0; y < out_h; ++y) {
    const int ys = flip_ud ? out_h - 1 - y : y;
    uint8_t* row = out + static_cast<size_t>(y) * out_w * 3;
    // incremental coords in double (no drift over a row); xs steps by -/+1
    const int xs0 = flip_lr ? out_w - 1 : 0;
    const double dcx = flip_lr ? -static_cast<double>(m0) : m0;
    const double dcy = flip_lr ? -static_cast<double>(m3) : m3;
    double cxd = static_cast<double>(m0) * xs0 + (static_cast<double>(m1) * ys + m2);
    double cyd = static_cast<double>(m3) * xs0 + (static_cast<double>(m4) * ys + m5);
    for (int x = 0; x < out_w; ++x, cxd += dcx, cyd += dcy) {
      const float cx = static_cast<float>(cxd);
      const float cy = static_cast<float>(cyd);
      const int x0 = static_cast<int>(std::floor(cx));
      const int y0 = static_cast<int>(std::floor(cy));
      const float fx = cx - x0;
      const float fy = cy - y0;
      uint8_t* px = row + x * 3;
      // fast path: the whole 2x2 neighbourhood inside one region (all but
      // seam and border pixels), the last region hit tested first
      const Region* hit = nullptr;
      if (x0 >= last->x1a && x0 + 1 < last->x2a && y0 >= last->y1a &&
          y0 + 1 < last->y2a) {
        hit = last;
      } else {
        for (int i = 0; i < nr; ++i) {
          const Region& r = regs[i];
          if (x0 >= r.x1a && x0 + 1 < r.x2a && y0 >= r.y1a && y0 + 1 < r.y2a) {
            hit = last = &r;
            break;
          }
        }
      }
      if (hit) {
        const uint8_t* p0 =
            hit->src +
            (static_cast<size_t>(y0 - hit->dy) * hit->w + (x0 - hit->dx)) * 3;
        const uint8_t* p1 = p0 + static_cast<size_t>(hit->w) * 3;
        for (int ch = 0; ch < 3; ++ch) {
          const float v0 = std::fma(static_cast<float>(p0[3 + ch] - p0[ch]), fx,
                                    static_cast<float>(p0[ch]));
          const float v1 = std::fma(static_cast<float>(p1[3 + ch] - p1[ch]), fx,
                                    static_cast<float>(p1[ch]));
          px[ch] = static_cast<uint8_t>(std::fma(v1 - v0, fy, v0) + 0.5f);
        }
      } else if (x0 + 1 < ux1 || x0 > ux2 - 1 || y0 + 1 < uy1 || y0 > uy2 - 1) {
        px[0] = px[1] = px[2] = pad;
      } else {
        uint8_t p00[3], p01[3], p10[3], p11[3];
        CanvasPx(regs, nr, x0, y0, pad, p00);
        CanvasPx(regs, nr, x0 + 1, y0, pad, p01);
        CanvasPx(regs, nr, x0, y0 + 1, pad, p10);
        CanvasPx(regs, nr, x0 + 1, y0 + 1, pad, p11);
        for (int ch = 0; ch < 3; ++ch) {
          const float v0 = std::fma(static_cast<float>(p01[ch] - p00[ch]), fx,
                                    static_cast<float>(p00[ch]));
          const float v1 = std::fma(static_cast<float>(p11[ch] - p10[ch]), fx,
                                    static_cast<float>(p10[ch]));
          px[ch] = static_cast<uint8_t>(std::fma(v1 - v0, fy, v0) + 0.5f);
        }
      }
    }
  }
  return 0;
}

// Mixup blend: a = trunc(a*r + b*(1-r)) in double, as numpy's
// (im*r + im2*(1-r)).astype(uint8). The build turns fp-contract off: an FMA
// of a*r with b*(1-r) rounds differently and flips ~0.1% of the pixels.
void yolov6_blend(uint8_t* a, const uint8_t* b, long n, double r) {
  for (long i = 0; i < n; ++i) {
    a[i] = static_cast<uint8_t>(a[i] * r + b[i] * (1.0 - r));
  }
}

// Aspect-keeping bilinear resize (half-pixel centres) + constant pad into
// dst[out_h, out_w, 3]. Returns the scale ratio; writes the left and top
// pads. The geometry of the reference letterbox with auto=False.
float yolov6_letterbox(const uint8_t* src, int h, int w, uint8_t* dst,
                       int out_h, int out_w, int scaleup, uint8_t pad_value,
                       int* pad_x, int* pad_y) {
  float r = std::min(static_cast<float>(out_h) / h, static_cast<float>(out_w) / w);
  if (!scaleup) r = std::min(r, 1.0f);
  int new_w = static_cast<int>(std::lround(w * r));
  int new_h = static_cast<int>(std::lround(h * r));
  float dw = (out_w - new_w) / 2.0f;
  float dh = (out_h - new_h) / 2.0f;
  int left = static_cast<int>(std::lround(dw - 0.1f));
  int top = static_cast<int>(std::lround(dh - 0.1f));
  *pad_x = left;
  *pad_y = top;

  std::memset(dst, pad_value, static_cast<size_t>(out_h) * out_w * 3);

  const float sx = static_cast<float>(w) / new_w;
  const float sy = static_cast<float>(h) / new_h;
  for (int y = 0; y < new_h; ++y) {
    float fy = std::fma(y + 0.5f, sy, -0.5f);
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, h - 1);
    y0 = std::max(y0, 0);
    uint8_t* drow = dst + (static_cast<size_t>(y + top) * out_w + left) * 3;
    const uint8_t* srow0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* srow1 = src + static_cast<size_t>(y1) * w * 3;
    for (int x = 0; x < new_w; ++x) {
      float fx = std::fma(x + 0.5f, sx, -0.5f);
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, w - 1);
      x0 = std::max(x0, 0);
      for (int c = 0; c < 3; ++c) {
        float v00 = srow0[x0 * 3 + c], v01 = srow0[x1 * 3 + c];
        float v10 = srow1[x0 * 3 + c], v11 = srow1[x1 * 3 + c];
        float v0 = std::fma(v01 - v00, wx, v00);
        float v1 = std::fma(v11 - v10, wx, v10);
        drow[x * 3 + c] = static_cast<uint8_t>(std::lround(std::fma(v1 - v0, wy, v0)));
      }
    }
  }
  return r;
}

}  // extern "C"
