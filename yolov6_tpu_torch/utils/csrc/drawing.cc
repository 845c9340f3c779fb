// cv2.rectangle, cv2.circle and cv2.fillPoly at LINE_AA on 8-bit images, as
// OpenCV 5.0 draws them (modules/imgproc/src/drawing.cpp): coordinates in
// 16-bit fixed point, anti-aliased edges from LineAA's filter tables, the
// convex fill and the edge-collection fill between them, thick lines as
// convex quadrilaterals with discs at their joints, and circles as the
// polygons ellipse2Poly makes from its table of sines. Standard library
// only; built by yolov6_tpu_torch/utils/draw.py.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

const int XY_SHIFT = 16;
const int64_t XY_ONE = (int64_t)1 << XY_SHIFT;

struct P {
  int64_t x, y;
  bool operator!=(const P& o) const { return x != o.x || y != o.y; }
};

struct Image {
  uint8_t* data;
  int rows, cols, ch;
  long step;
  int color[4];
  uint8_t* at(int x, int y) const { return data + (long)y * step + (long)x * ch; }
};

const uint8_t SlopeCorrTable[] = {181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190,
                                  192, 194, 196, 198, 201, 203, 206, 209, 211, 214, 218,
                                  221, 224, 227, 231, 235, 238, 242, 246, 250, 254};

const int FilterTable[] = {168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249,
                           252, 254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218,
                           210, 202, 194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105,
                           97,  89,  82,  75,  68,  62,  56,  50,  45,  40,  36,  32,  28,
                           25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

// sin of 0..450 degrees to 7 decimals, as cv2's table for ellipse2Poly
// holds it (float)
float SinTable[451];

struct SinInit {
  SinInit() {
    for (int i = 0; i <= 450; ++i)
      SinTable[i] = (float)(std::nearbyint(std::sin(i * M_PI / 180.0) * 1e7) / 1e7);
  }
} sin_init;

// the clip of cv2's clipLine to [0, w - 1] x [0, h - 1]
bool clip_line(int64_t w, int64_t h, P& p1, P& p2) {
  int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return false;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// LineAA's blend of one pixel; cv2 applies its step twice on 3-channel
// images and once on 1- and 4-channel ones
inline void blend(const Image& im, int x, int y, int a) {
  uint8_t* t = im.at(x, y);
  for (int k = 0; k < im.ch; ++k) {
    int v = t[k];
    v += ((im.color[k] - v) * a + 127) >> 8;
    if (im.ch == 3) v += ((im.color[k] - v) * a + 127) >> 8;
    t[k] = (uint8_t)v;
  }
}

// cv2's LineAA between fixed-point ends
void line_aa(const Image& im, P pt1, P pt2) {
  int64_t dx, dy;
  int ecount, scount = 0;
  int slope;
  int64_t ax, ay;
  int64_t x_step, y_step;
  int64_t i, j;
  int ep_table[9];
  int64_t w0 = im.cols, h0 = im.rows;
  if (!clip_line(w0 << XY_SHIFT, h0 << XY_SHIFT, pt1, pt2)) return;
  dx = pt2.x - pt1.x;
  dy = pt2.y - pt1.y;
  j = dx < 0 ? -1 : 0;
  ax = (dx ^ j) - j;
  i = dy < 0 ? -1 : 0;
  ay = (dy ^ i) - i;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    pt1.x ^= pt2.x & j;
    pt2.x ^= pt1.x & j;
    pt1.x ^= pt2.x & j;
    pt1.y ^= pt2.y & j;
    pt2.y ^= pt1.y & j;
    pt1.y ^= pt2.y & j;
    x_step = XY_ONE;
    y_step = (dy << XY_SHIFT) / (ax | 1);
    pt2.x += XY_ONE;
    ecount = (int)((pt2.x >> XY_SHIFT) - (pt1.x >> XY_SHIFT));
    j = -(pt1.x & (XY_ONE - 1));
    pt1.y += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = (y_step >> (XY_SHIFT - 5)) & 0x3f;
    slope ^= (y_step < 0 ? 0x3f : 0);
    i = (pt1.x >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.x >> (XY_SHIFT - 7)) & 0x78;
  } else {
    dx = (dx ^ i) - i;
    pt1.x ^= pt2.x & i;
    pt2.x ^= pt1.x & i;
    pt1.x ^= pt2.x & i;
    pt1.y ^= pt2.y & i;
    pt2.y ^= pt1.y & i;
    pt1.y ^= pt2.y & i;
    x_step = (dx << XY_SHIFT) / (ay | 1);
    y_step = XY_ONE;
    pt2.y += XY_ONE;
    ecount = (int)((pt2.y >> XY_SHIFT) - (pt1.y >> XY_SHIFT));
    j = -(pt1.y & (XY_ONE - 1));
    pt1.x += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = (x_step >> (XY_SHIFT - 5)) & 0x3f;
    slope ^= (x_step < 0 ? 0x3f : 0);
    i = (pt1.y >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.y >> (XY_SHIFT - 7)) & 0x78;
  }
  slope = (slope & 0x20) ? 0x100 : SlopeCorrTable[slope];
  {
    int t0 = slope << 7;
    int t1 = ((0x78 - (int)i) | 4) * slope;
    int t2 = ((int)j | 4) * slope;
    ep_table[0] = 0;
    ep_table[8] = slope;
    ep_table[1] = ep_table[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff;
    ep_table[2] = (t1 >> 8) & 0x1ff;
    ep_table[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff;
    ep_table[5] = ((t1 + t0) >> 8) & 0x1ff;
    ep_table[6] = (t2 >> 8) & 0x1ff;
    ep_table[7] = ((t2 + t0) >> 8) & 0x1ff;
  }
  if (ax > ay) {
    int x = (int)(pt1.x >> XY_SHIFT);
    for (; ecount >= 0; x++, pt1.y += y_step, scount++, ecount--) {
      if ((unsigned)x >= (unsigned)w0) continue;
      int y = (int)((pt1.y >> XY_SHIFT) - 1);
      int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                             (((ecount >= 2) + 1) & (ecount | 2))];
      int a, dist = (pt1.y >> (XY_SHIFT - 5)) & 31;
      a = (ep_corr * FilterTable[dist + 32] >> 8) & 0xff;
      if ((unsigned)y < (unsigned)h0) blend(im, x, y, a);
      a = (ep_corr * FilterTable[dist] >> 8) & 0xff;
      if ((unsigned)(y + 1) < (unsigned)h0) blend(im, x, y + 1, a);
      a = (ep_corr * FilterTable[63 - dist] >> 8) & 0xff;
      if ((unsigned)(y + 2) < (unsigned)h0) blend(im, x, y + 2, a);
    }
  } else {
    int y = (int)(pt1.y >> XY_SHIFT);
    for (; ecount >= 0; y++, pt1.x += x_step, scount++, ecount--) {
      if ((unsigned)y >= (unsigned)h0) continue;
      int x = (int)((pt1.x >> XY_SHIFT) - 1);
      int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                             (((ecount >= 2) + 1) & (ecount | 2))];
      int a, dist = (pt1.x >> (XY_SHIFT - 5)) & 31;
      a = (ep_corr * FilterTable[dist + 32] >> 8) & 0xff;
      if ((unsigned)x < (unsigned)w0) blend(im, x, y, a);
      a = (ep_corr * FilterTable[dist] >> 8) & 0xff;
      if ((unsigned)(x + 1) < (unsigned)w0) blend(im, x + 1, y, a);
      a = (ep_corr * FilterTable[63 - dist] >> 8) & 0xff;
      if ((unsigned)(x + 2) < (unsigned)w0) blend(im, x + 2, y, a);
    }
  }
}

void hline(const Image& im, int y, int x1, int x2) {
  for (int x = x1; x <= x2; ++x) {
    uint8_t* t = im.at(x, y);
    for (int k = 0; k < im.ch; ++k) t[k] = (uint8_t)im.color[k];
  }
}

// cv2's FillConvexPoly at LINE_AA: the anti-aliased edges, then the rows
// between them
void fill_convex_poly(const Image& im, const P* v, int npts, int shift) {
  struct {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  int delta = 1 << shift >> 1;
  int i, y, imin = 0;
  int edges = npts;
  int64_t xmin, xmax, ymin, ymax;
  P p0;
  int delta1 = (int)(XY_ONE - 1), delta2 = 0;
  p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  xmin = xmax = v[0].x;
  ymin = ymax = v[0].y;
  for (i = 0; i < npts; i++) {
    P p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    line_aa(im, p0, p);
    p0 = p;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= im.cols ||
      (int)ymin >= im.rows)
    return;
  ymax = std::min<int64_t>(ymax, im.rows - 1);
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = y = (int)ymin;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  do {
    if (y < (int)ymax || y == (int)ymin) {
      for (i = 0; i < 2; i++) {
        if (y >= edge[i].ye) {
          int idx0 = edge[i].idx, di = edge[i].di;
          int idx = idx0 + di;
          if (idx >= npts) idx -= npts;
          int ty = 0;
          for (; edges-- > 0;) {
            ty = (int)((v[idx].y + delta) >> shift);
            if (ty > y) {
              int64_t xs = v[idx0].x;
              int64_t xe = v[idx].x;
              if (shift != XY_SHIFT) {
                xs <<= XY_SHIFT - shift;
                xe <<= XY_SHIFT - shift;
              }
              edge[i].ye = ty;
              edge[i].dx = ((xe - xs) * 2 + ((int64_t)ty - y)) / (2 * ((int64_t)ty - y));
              edge[i].x = xs;
              edge[i].idx = idx;
              break;
            }
            idx0 = idx;
            idx += di;
            if (idx >= npts) idx -= npts;
          }
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) left = 1, right = 0;
      int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < im.cols) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= im.cols) xx2 = im.cols - 1;
        hline(im, y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= (int)ymax);
}

struct PolyEdge {
  int y0 = 0, y1 = 0;
  int64_t x = 0, dx = 0;
  PolyEdge* next = nullptr;
};

// cv2's CollectPolyEdges at LINE_AA (no offset)
void collect_poly_edges(const Image& im, const P* v, int count, std::vector<PolyEdge>& edges,
                        int shift) {
  int i, delta = (1 << shift) >> 1;
  P pt0 = v[count - 1], pt1;
  pt0.x = pt0.x << (XY_SHIFT - shift);
  pt0.y = (pt0.y + delta) >> shift;
  for (i = 0; i < count; i++, pt0 = pt1) {
    P t0, t1;
    PolyEdge edge;
    pt1 = v[i];
    pt1.x = pt1.x << (XY_SHIFT - shift);
    pt1.y = (pt1.y + delta) >> shift;
    P pt0c(pt0), pt1c(pt1);
    t0.x = pt0.x;
    t1.x = pt1.x;
    t0.y = pt0.y << XY_SHIFT;
    t1.y = pt1.y << XY_SHIFT;
    line_aa(im, t0, t1);
    if (pt0.y == pt1.y) continue;
    edge.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
    if (pt0.y < pt1.y) {
      edge.y0 = (int)(pt0.y);
      edge.y1 = (int)(pt1.y);
      edge.x = pt0c.x + (pt0.y - pt0c.y) * edge.dx;
    } else {
      edge.y0 = (int)(pt1.y);
      edge.y1 = (int)(pt0.y);
      edge.x = pt1c.x + (pt1.y - pt1c.y) * edge.dx;
    }
    edges.push_back(edge);
  }
}

// cv2's FillEdgeCollection at LINE_AA
void fill_edge_collection(const Image& im, std::vector<PolyEdge>& edges) {
  PolyEdge tmp;
  int i, y, total = (int)edges.size();
  PolyEdge* e;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = (int64_t)0xFFFFFFFFFFFFFFFF, x_min = 0x7FFFFFFFFFFFFFFF;
  int delta = (int)(XY_ONE - 1);
  if (total < 2) return;
  for (i = 0; i < total; i++) {
    PolyEdge& e1 = edges[i];
    int64_t x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
    y_min = std::min(y_min, e1.y0);
    y_max = std::max(y_max, e1.y1);
    x_min = std::min(x_min, e1.x);
    x_max = std::max(x_max, e1.x);
    x_min = std::min(x_min, x1);
    x_max = std::max(x_max, x1);
  }
  if (y_max < 0 || y_min >= im.rows || x_max < 0 || x_min >= ((int64_t)im.cols << XY_SHIFT))
    return;
  std::sort(edges.begin(), edges.end(), [](const PolyEdge& e1, const PolyEdge& e2) {
    return e1.y0 - e2.y0 ? e1.y0 < e2.y0 : e1.x - e2.x ? e1.x < e2.x : e1.dx < e2.dx;
  });
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);
  i = 0;
  tmp.next = 0;
  e = &edges[i];
  y_max = std::min(y_max, im.rows);
  for (y = e->y0; y < y_max; y++) {
    PolyEdge *last, *prelast, *keep_prelast;
    int draw = 0;
    int clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          if (keep_prelast->x > prelast->x) {
            x1 = (int)((prelast->x + delta) >> XY_SHIFT);
            x2 = (int)(keep_prelast->x >> XY_SHIFT);
          } else {
            x1 = (int)((keep_prelast->x + delta) >> XY_SHIFT);
            x2 = (int)(prelast->x >> XY_SHIFT);
          }
          if (x1 < im.cols && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= im.cols) x2 = im.cols - 1;
            hline(im, y, x1, x2);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // sort the active edges by x (bubble sort)
    keep_prelast = 0;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = 0;
      while (last != keep_prelast && last->next != 0) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == NULL) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

// cv2's ellipse2Poly for a whole circle or ellipse at angle 0
void ellipse_2_poly(double cx, double cy, double aw, double ah, int delta,
                    std::vector<std::pair<double, double>>& pts) {
  float alpha = SinTable[450], beta = SinTable[0];  // sincos(0)
  pts.clear();
  for (int i = 0; i < 360 + delta; i += delta) {
    int angle = i;
    if (angle > 360) angle = 360;
    double x = aw * SinTable[450 - angle];
    double y = ah * SinTable[angle];
    pts.emplace_back(cx + x * alpha - y * beta, cy + x * beta + y * alpha);
  }
  if (pts.size() == 1) pts.assign(2, std::make_pair(cx, cy));
}

void poly_line(const Image& im, const P* v, int count, bool closed, int thickness, int shift);

// cv2's EllipseEx for a whole circle of fixed-point centre and axes
void ellipse_ex(const Image& im, P center, int64_t aw, int64_t ah, int thickness) {
  aw = std::abs(aw), ah = std::abs(ah);
  int delta = (int)((std::max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  std::vector<std::pair<double, double>> pv;
  ellipse_2_poly((double)center.x, (double)center.y, (double)aw, (double)ah, delta, pv);
  std::vector<P> v;
  P prev{(int64_t)0xFFFFFFFFFFFFFFFF, (int64_t)0xFFFFFFFFFFFFFFFF};
  for (const auto& q : pv) {
    P pt;
    pt.x = (int64_t)std::lrint(q.first / (double)XY_ONE) << XY_SHIFT;
    pt.y = (int64_t)std::lrint(q.second / (double)XY_ONE) << XY_SHIFT;
    pt.x += std::lrint(q.first - pt.x);
    pt.y += std::lrint(q.second - pt.y);
    if (pt != prev) {
      v.push_back(pt);
      prev = pt;
    }
  }
  if (v.size() == 1) v.assign(2, center);
  if (thickness >= 0)
    poly_line(im, v.data(), (int)v.size(), false, thickness, XY_SHIFT);
  else
    fill_convex_poly(im, v.data(), (int)v.size(), XY_SHIFT);
}

// cv2's ThickLine at LINE_AA; flags bit 0/1 put a disc at the first/second
// end
void thick_line(const Image& im, P p0, P p1, int thickness, int flags, int shift) {
  const double INV_XY_ONE = 1. / XY_ONE;
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  p1.x <<= XY_SHIFT - shift;
  p1.y <<= XY_SHIFT - shift;
  if (thickness <= 1) {
    line_aa(im, p0, p1);
    return;
  }
  P pt[4], dp = {0, 0};
  double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
  double r = dx * dx + dy * dy;
  int i, odd = thickness & 1;
  int64_t th = (int64_t)thickness << (XY_SHIFT - 1);
  if (std::fabs(r) > 2.2204460492503131e-16) {
    r = (th + odd * XY_ONE * 0.5) / std::sqrt(r);
    dp.x = std::lrint(dy * r);
    dp.y = std::lrint(dx * r);
    pt[0].x = p0.x + dp.x;
    pt[0].y = p0.y + dp.y;
    pt[1].x = p0.x - dp.x;
    pt[1].y = p0.y - dp.y;
    pt[2].x = p1.x - dp.x;
    pt[2].y = p1.y - dp.y;
    pt[3].x = p1.x + dp.x;
    pt[3].y = p1.y + dp.y;
    fill_convex_poly(im, pt, 4, XY_SHIFT);
  }
  for (i = 0; i < 2; i++) {
    if (flags & (i + 1)) ellipse_ex(im, p0, th, th, -1);
    p0 = p1;
  }
}

void poly_line(const Image& im, const P* v, int count, bool closed, int thickness, int shift) {
  if (!v || count <= 0) return;
  int i = closed ? count - 1 : 0;
  int flags = 2 + !closed;
  P p0 = v[i];
  for (i = !closed; i < count; i++) {
    P p = v[i];
    thick_line(im, p0, p, thickness, flags, shift);
    p0 = p;
    flags = 2;
  }
}

Image image(uint8_t* data, int rows, int cols, int ch, long step, const int* color) {
  Image im{data, rows, cols, ch, step, {0, 0, 0, 0}};
  for (int k = 0; k < ch && k < 4; ++k) im.color[k] = color[k];
  return im;
}

}  // namespace

extern "C" {

// cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness, cv2.LINE_AA):
// the closed polyline of its corners, or (thickness < 0) the convex fill
void yolov6_rectangle_aa(uint8_t* data, int rows, int cols, int ch, long step, const int* color,
                         int x1, int y1, int x2, int y2, int thickness) {
  Image im = image(data, rows, cols, ch, step, color);
  P pt[4] = {{x1, y1}, {x2, y1}, {x2, y2}, {x1, y2}};
  if (thickness >= 0)
    poly_line(im, pt, 4, true, thickness, 0);
  else
    fill_convex_poly(im, pt, 4, 0);
}

// cv2.circle(img, (cx, cy), radius, color, thickness, cv2.LINE_AA)
void yolov6_circle_aa(uint8_t* data, int rows, int cols, int ch, long step, const int* color,
                      int cx, int cy, int radius, int thickness) {
  Image im = image(data, rows, cols, ch, step, color);
  P c{(int64_t)cx << XY_SHIFT, (int64_t)cy << XY_SHIFT};
  int64_t r = (int64_t)radius << XY_SHIFT;
  ellipse_ex(im, c, r, r, thickness);
}

// cv2.fillPoly(img, contours, color, cv2.LINE_AA): counts[i] points a
// contour, xy their coordinates in turn
void yolov6_fill_poly_aa(uint8_t* data, int rows, int cols, int ch, long step, const int* color,
                         const int* xy, const int* counts, int ncontours) {
  Image im = image(data, rows, cols, ch, step, color);
  std::vector<PolyEdge> edges;
  for (int c = 0, k = 0; c < ncontours; k += counts[c++]) {
    if (counts[c] <= 0) continue;
    std::vector<P> pts(counts[c]);
    for (int i = 0; i < counts[c]; ++i) pts[i] = P{xy[2 * (k + i)], xy[2 * (k + i) + 1]};
    collect_poly_edges(im, pts.data(), counts[c], edges, 0);
  }
  fill_edge_collection(im, edges);
}

}  // extern "C"
