// TrueType text as OpenCV 5.0's cv2.putText and cv2.getTextSize draw and
// measure it (modules/imgproc/src/drawing_text.cpp over OpenCV's patched
// stb_truetype): the font's tables, its variations along the weight axis in
// OpenCV's integer arithmetic, stb_truetype's outline flattening and
// signed-area coverage rasteriser, and the blend of the coverage into an
// 8-bit image. Standard library only; built by yolov6_tpu_torch/utils/text.py.
//
// The float arithmetic follows stb_truetype's, operation for operation: a
// pixel's coverage is a sum of floats whose order decides its last bit, and
// so the 8-bit value it rounds to. Build without FMA contraction
// (-ffp-contract=off).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <vector>

namespace {

// ---------------------------------------------------------------- reading

inline uint8_t u8(const uint8_t* p) { return p[0]; }
inline int8_t i8(const uint8_t* p) { return (int8_t)p[0]; }
inline uint16_t u16(const uint8_t* p) { return (uint16_t)(p[0] << 8 | p[1]); }
inline int16_t i16(const uint8_t* p) { return (int16_t)u16(p); }
inline uint32_t u32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}
inline int32_t i32(const uint8_t* p) { return (int32_t)u32(p); }
inline float f2dot14(const uint8_t* p) { return i16(p) / 16384.0f; }


// one glyph of a text as OpenCV's glyph cache holds it: its coverage
// cropped to the pixels it touches, their top left relative to the pen on
// the baseline, and the pen's advance in whole pixels
struct Placed {
  int left = 0, top = 0, w = 0, h = 0, advance = 0;
  std::vector<uint8_t> px;
};

struct Font {
  std::vector<uint8_t> data;
  uint32_t cmap = 0, head = 0, hhea = 0, hmtx = 0, maxp = 0, loca = 0, glyf = 0;
  uint32_t fvar = 0, avar = 0, gvar = 0;
  uint32_t glyf_len = 0, gvar_len = 0;
  int num_glyphs = 0, index_to_loc = 0, num_hmetrics = 0, ascent = 0;
  uint32_t cmap_sub = 0;  // the Unicode subtable
  int cmap_format = 0;
  // variations: the axes, and the instance's normalised coordinates
  // (F2DOT14, after avar)
  int axis_count = 0;
  std::vector<float> axis_min, axis_def, axis_max;
  int wght_axis = -1;
  std::vector<int> coords;
  std::map<std::tuple<int, int, int>, Placed> cache;  // (glyph, size, weight)
  std::mutex lock;

  const uint8_t* at(uint32_t off) const { return data.data() + off; }
  bool has(uint32_t off, uint32_t n) const { return (uint64_t)off + n <= data.size(); }
};

uint32_t find_table(const Font& f, const char* tag) {
  if (!f.has(0, 12)) return 0;
  int n = u16(f.at(4));
  for (int i = 0; i < n; ++i) {
    uint32_t rec = 12 + 16 * i;
    if (!f.has(rec, 16)) return 0;
    if (memcmp(f.at(rec), tag, 4) == 0) {
      uint32_t off = u32(f.at(rec + 8)), len = u32(f.at(rec + 12));
      return f.has(off, len) ? off : 0;
    }
  }
  return 0;
}

uint32_t table_len(const Font& f, const char* tag) {
  int n = u16(f.at(4));
  for (int i = 0; i < n; ++i) {
    uint32_t rec = 12 + 16 * i;
    if (memcmp(f.at(rec), tag, 4) == 0) return u32(f.at(rec + 12));
  }
  return 0;
}

int glyph_index(const Font& f, uint32_t cp) {
  const uint8_t* t = f.at(f.cmap_sub);
  if (f.cmap_format == 4) {
    if (cp > 0xFFFF) return 0;
    int segx2 = u16(t + 6);
    const uint8_t* ends = t + 14;
    const uint8_t* starts = ends + segx2 + 2;
    const uint8_t* deltas = starts + segx2;
    const uint8_t* ranges = deltas + segx2;
    for (int i = 0; i < segx2 / 2; ++i) {
      uint32_t end = u16(ends + 2 * i);
      if (cp > end) continue;
      uint32_t start = u16(starts + 2 * i);
      if (cp < start) return 0;
      uint32_t ro = u16(ranges + 2 * i);
      if (ro == 0) return (cp + i16(deltas + 2 * i)) & 0xFFFF;
      const uint8_t* p = ranges + 2 * i + ro + 2 * (cp - start);
      if (!f.has((uint32_t)(p - f.at(0)), 2)) return 0;
      int g = u16(p);
      return g ? (g + i16(deltas + 2 * i)) & 0xFFFF : 0;
    }
    return 0;
  }
  if (f.cmap_format == 12) {
    uint32_t n = u32(t + 12);
    for (uint32_t i = 0; i < n; ++i) {
      const uint8_t* g = t + 16 + 12 * i;
      uint32_t s = u32(g), e = u32(g + 4);
      if (cp >= s && cp <= e) return (int)(u32(g + 8) + cp - s);
    }
  }
  return 0;
}

// where glyph g's data lies in glyf, or -1 for an empty glyph
int glyph_offset(const Font& f, int g, uint32_t* len) {
  if (g < 0 || g >= f.num_glyphs) return -1;
  uint32_t a, b;
  if (f.index_to_loc == 0) {
    a = 2u * u16(f.at(f.loca + 2 * g));
    b = 2u * u16(f.at(f.loca + 2 * g + 2));
  } else {
    a = u32(f.at(f.loca + 4 * g));
    b = u32(f.at(f.loca + 4 * g + 4));
  }
  if (a >= b || b > f.glyf_len) return -1;
  *len = b - a;
  return (int)(f.glyf + a);
}

// ---------------------------------------------------------------- variations

// packed point numbers at *p; an empty list means every point
const uint8_t* read_points(const uint8_t* p, const uint8_t* end, std::vector<int>& pts, bool* all) {
  pts.clear();
  if (p >= end) return nullptr;
  int n = *p++;
  if (n & 0x80) {
    if (p >= end) return nullptr;
    n = (n & 0x7F) << 8 | *p++;
  }
  *all = n == 0;
  int last = 0;
  while ((int)pts.size() < n) {
    if (p >= end) return nullptr;
    int ctrl = *p++;
    int run = (ctrl & 0x7F) + 1;
    bool words = ctrl & 0x80;
    for (int i = 0; i < run && (int)pts.size() < n; ++i) {
      if (p + (words ? 2 : 1) > end) return nullptr;
      last += words ? u16(p) : *p;
      p += words ? 2 : 1;
      pts.push_back(last);
    }
  }
  return p;
}

const uint8_t* read_deltas(const uint8_t* p, const uint8_t* end, int n, std::vector<int>& out) {
  out.clear();
  while ((int)out.size() < n) {
    if (p >= end) return nullptr;
    int ctrl = *p++;
    int run = (ctrl & 0x3F) + 1;
    for (int i = 0; i < run && (int)out.size() < n; ++i) {
      if (ctrl & 0x80) {
        out.push_back(0);
      } else if (ctrl & 0x40) {
        if (p + 2 > end) return nullptr;
        out.push_back(i16(p));
        p += 2;
      } else {
        if (p + 1 > end) return nullptr;
        out.push_back(i8(p));
        p += 1;
      }
    }
  }
  return p;
}

// one untouched point's delta, interpolated between the touched points
// p and q in their original coordinates c, in truncating integer arithmetic
inline int interpolate(int v, int cp, int cq, int dp, int dq) {
  if (cp == cq) return dp == dq ? dp : 0;
  if (cp > cq) {
    std::swap(cp, cq);
    std::swap(dp, dq);
  }
  if (v <= cp) return dp;
  if (v >= cq) return dq;
  return (dp * (cq - cp) + (v - cp) * (dq - dp)) / (cq - cp);
}

// IUP as OpenCV 5.0's stb_truetype does it: a tuple's integer deltas d for
// the points it leaves untouched (marked none) inferred along each contour
// (ends holds each contour's last point) from the touched points around
// them. One departure from the OpenType rule is kept: when a contour's first
// point is untouched, the points after its last touched point take that
// point's delta instead of interpolating towards the first touched point.
void infer_untouched(std::vector<int>& dx, std::vector<int>& dy, const std::vector<int>& x,
                     const std::vector<int>& y, const std::vector<int>& ends, int none) {
  auto set = [&](int i, int p, int q) {
    dx[i] = interpolate(x[i], x[p], x[q], dx[p], dx[q]);
    dy[i] = interpolate(y[i], y[p], y[q], dy[p], dy[q]);
  };
  int start = 0;
  for (int end : ends) {
    if (end < start) continue;
    int wrap = start, prev = start, next = -1, i = start;
    if (dx[start] == none) {
      int k = end;
      while (k > start && dx[k] == none) --k;
      if (k == start) {  // nothing touched: no deltas
        for (int j = start; j <= end; ++j) dx[j] = dy[j] = 0;
        start = end + 1;
        continue;
      }
      wrap = prev = k;
      next = start + 1;
      while (dx[next] == none) ++next;
      set(start, prev, next);
    }
    for (++i; i <= end; ++i) {
      if (dx[i] != none) {
        if (next == i) next = -1;
        prev = i;
        continue;
      }
      if (next < 0) {
        next = i + 1;
        while (next <= end && dx[next] == none) ++next;
        if (next > end) next = wrap;
      }
      set(i, prev, next);
    }
    start = end + 1;
  }
}

// the scalar of a gvar tuple in 16.16, in OpenCV's integer arithmetic
// (truncating divisions); coords and the region are F2DOT14
int tuple_scalar(const Font& f, const int* peak, const int* start, const int* end) {
  int64_t s = 0x10000;
  for (int a = 0; a < f.axis_count; ++a) {
    int p = peak[a], c = f.coords[a];
    if (p == 0 || p == c) continue;
    if (c == 0) return 0;
    if (start) {
      int lo = start[a], hi = end[a];
      if (hi < c || lo > c) return 0;
      if (p > c)
        s = s * (c - lo) / (p - lo);
      else
        s = s * (hi - c) / (hi - p);
    } else {
      if (c > 0 ? c > p : c < p) return 0;
      s = s * c / p;
    }
  }
  return (int)s;
}

// gvar's deltas for glyph g's n points (the outline's, then the 4 phantom
// points) at x and y in font units: each tuple's integer deltas (IUP for
// the points it leaves out, along the contours ending at ends; none for a
// composite glyph, whose "points" are its components' offsets) times its
// scalar, summed in 24.8 fixed point; the point moves by the sum's floor
void apply_gvar(const Font& f, int g, std::vector<int>& x, std::vector<int>& y,
                const std::vector<int>& ends) {
  if (!f.gvar || f.coords.empty()) return;
  const uint8_t* gv = f.at(f.gvar);
  int axes = u16(gv + 4), shared_count = u16(gv + 6);
  uint32_t shared_off = u32(gv + 8);
  int glyph_count = u16(gv + 12), flags = u16(gv + 14);
  uint32_t data_off = u32(gv + 16);
  if (g >= glyph_count || axes != f.axis_count) return;
  uint32_t a, b;
  if (flags & 1) {
    a = u32(gv + 20 + 4 * g);
    b = u32(gv + 20 + 4 * g + 4);
  } else {
    a = 2u * u16(gv + 20 + 2 * g);
    b = 2u * u16(gv + 20 + 2 * g + 2);
  }
  if (a >= b || data_off + b > f.gvar_len) return;
  const uint8_t* gvd = gv + data_off + a;
  const uint8_t* gend = gv + data_off + b;
  int count = u16(gvd);
  const uint8_t* ser = gvd + u16(gvd + 2);
  const uint8_t* hdr = gvd + 4;
  int n = (int)x.size();
  std::vector<int> shared_pts, pts, ddx, ddy;
  bool shared_all = true;
  if (count & 0x8000) {
    ser = read_points(ser, gend, shared_pts, &shared_all);
    if (!ser) return;
  }
  const int none = -32768;
  std::vector<int> peak(axes), start(axes), end(axes);
  std::vector<int> ax(n, 0), ay(n, 0), dx(n), dy(n);
  for (int t = 0; t < (count & 0x0FFF); ++t) {
    int size = u16(hdr), index = u16(hdr + 2);
    hdr += 4;
    if (index & 0x8000) {
      for (int k = 0; k < axes; ++k) peak[k] = i16(hdr + 2 * k);
      hdr += 2 * axes;
    } else {
      int si = index & 0x0FFF;
      if (si >= shared_count) return;
      const uint8_t* sp = gv + shared_off + 2 * axes * si;
      for (int k = 0; k < axes; ++k) peak[k] = i16(sp + 2 * k);
    }
    bool inter = index & 0x4000;
    if (inter) {
      for (int k = 0; k < axes; ++k) start[k] = i16(hdr + 2 * k);
      hdr += 2 * axes;
      for (int k = 0; k < axes; ++k) end[k] = i16(hdr + 2 * k);
      hdr += 2 * axes;
    }
    const uint8_t* tuple = ser;
    ser += size;
    int s = tuple_scalar(f, peak.data(), inter ? start.data() : nullptr,
                         inter ? end.data() : nullptr);
    if (s == 0) continue;
    const uint8_t* p = tuple;
    bool all = shared_all;
    const std::vector<int>* use = &shared_pts;
    if (index & 0x2000) {
      p = read_points(p, ser, pts, &all);
      if (!p) return;
      use = &pts;
    }
    int np = all ? n : (int)use->size();
    p = read_deltas(p, ser, np, ddx);
    if (!p) return;
    p = read_deltas(p, ser, np, ddy);
    if (!p) return;
    if (all) {
      dx = ddx;
      dy = ddy;
    } else {
      std::fill(dx.begin(), dx.end(), none);
      std::fill(dy.begin(), dy.end(), none);
      for (int k = 0; k < np; ++k) {
        int i = (*use)[k];
        if (i >= n) continue;
        dx[i] = ddx[k];
        dy[i] = ddy[k];
      }
      if (!ends.empty()) infer_untouched(dx, dy, x, y, ends, none);
      for (int i = 0; i < n; ++i) {
        if (dx[i] == none) dx[i] = 0;
        if (dy[i] == none) dy[i] = 0;
      }
    }
    for (int i = 0; i < n; ++i) {
      ax[i] += (dx[i] * s) >> 8;
      ay[i] += (dy[i] * s) >> 8;
    }
  }
  for (int i = 0; i < n; ++i) {
    x[i] += ax[i] >> 8;
    y[i] += ay[i] >> 8;
  }
}

// ---------------------------------------------------------------- outlines

enum { V_MOVE = 1, V_LINE = 2, V_CURVE = 3 };

// stb_truetype's vertex: short coordinates in font units
struct Vertex {
  int16_t x, y, cx, cy;
  uint8_t type;
};

Vertex vertex(uint8_t type, int32_t x, int32_t y, int32_t cx, int32_t cy) {
  return Vertex{(int16_t)x, (int16_t)y, (int16_t)cx, (int16_t)cy, type};
}

void close_shape(std::vector<Vertex>& v, int was_off, int start_off, int32_t sx, int32_t sy,
                 int32_t scx, int32_t scy, int32_t cx, int32_t cy) {
  if (start_off) {
    if (was_off) v.push_back(vertex(V_CURVE, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy));
    v.push_back(vertex(V_CURVE, sx, sy, scx, scy));
  } else if (was_off) {
    v.push_back(vertex(V_CURVE, sx, sy, cx, cy));
  } else {
    v.push_back(vertex(V_LINE, sx, sy, 0, 0));
  }
}

// What gvar does to a glyph besides its outline: the box OpenCV rasterises
// in (the glyph header's box, its x ends moved with the side-bearing and
// advance phantom points and its y ends with the top and bottom ones, as
// OpenCV pairs them) and the advance (hmtx's, moved by the phantom points).
struct Metrics {
  int box[4] = {0, 0, 0, 0};  // x0, y0, x1, y1
  int advance = 0;
};

// gvar over n points then the 4 phantom points, and the metrics they move
void vary(const Font& f, int g, std::vector<int>& xs, std::vector<int>& ys,
          const std::vector<int>& ends, Metrics* m) {
  int n = (int)xs.size() - 4;
  int p0 = xs[n], p1 = xs[n + 1], p2 = ys[n + 2], p3 = ys[n + 3];
  apply_gvar(f, g, xs, ys, ends);
  if (!m) return;
  m->box[0] += xs[n] - p0;
  m->box[1] += ys[n + 2] - p2;
  m->box[2] += xs[n + 1] - p1;
  m->box[3] += ys[n + 3] - p3;
  m->advance += (xs[n + 1] - p1) - (xs[n] - p0);
}

// glyph g's outline at the instance's coordinates, as stb_truetype's
// vertex list, and (for the outermost glyph) its metrics
bool glyph_shape(const Font& f, int g, std::vector<Vertex>& out, Metrics* m, int depth = 0) {
  out.clear();
  int hi = g < f.num_hmetrics ? g : f.num_hmetrics - 1;
  int adv = u16(f.at(f.hmtx + 4 * hi));
  int lsb = g < f.num_hmetrics ? i16(f.at(f.hmtx + 4 * g + 2))
                               : i16(f.at(f.hmtx + 4 * f.num_hmetrics + 2 * (g - f.num_hmetrics)));
  if (m) *m = Metrics{{0, 0, 0, 0}, adv};
  uint32_t len;
  int off = glyph_offset(f, g, &len);
  if (off < 0) return true;  // no outline, no variations
  if (len < 10 || depth > 8) return false;
  const uint8_t* d = f.at(off);
  const uint8_t* dend = d + len;
  int nc = i16(d), xmin = i16(d + 2);
  if (m) {
    m->box[0] = xmin;
    m->box[1] = i16(d + 4);
    m->box[2] = i16(d + 6);
    m->box[3] = i16(d + 8);
  }
  if (nc > 0) {
    const uint8_t* ends = d + 10;
    if (ends + 2 * nc + 2 > dend) return false;
    int ins = u16(ends + 2 * nc);
    const uint8_t* p = ends + 2 * nc + 2 + ins;
    int n = 1 + u16(ends + 2 * nc - 2);
    std::vector<int> endpts(nc);
    for (int i = 0; i < nc; ++i) endpts[i] = u16(ends + 2 * i);
    std::vector<uint8_t> flags(n);
    int flagcount = 0;
    uint8_t fl = 0;
    for (int i = 0; i < n; ++i) {
      if (flagcount == 0) {
        if (p >= dend) return false;
        fl = *p++;
        if (fl & 8) {
          if (p >= dend) return false;
          flagcount = *p++;
        }
      } else {
        --flagcount;
      }
      flags[i] = fl;
    }
    std::vector<int> xs(n + 4), ys(n + 4);
    for (int axis = 0; axis < 2; ++axis) {
      std::vector<int>& c = axis ? ys : xs;
      int short_bit = axis ? 4 : 2, same_bit = axis ? 32 : 16;
      int32_t v = 0;
      for (int i = 0; i < n; ++i) {
        if (flags[i] & short_bit) {
          if (p >= dend) return false;
          int16_t dv = *p++;
          v += (flags[i] & same_bit) ? dv : -dv;
        } else if (!(flags[i] & same_bit)) {
          if (p + 2 > dend) return false;
          v = v + (int16_t)(p[0] * 256 + p[1]);
          p += 2;
        }
        c[i] = (int16_t)v;
      }
    }
    // the phantom points: side bearing, advance, top, bottom
    xs[n] = xmin - lsb;
    xs[n + 1] = xs[n] + adv;
    vary(f, g, xs, ys, endpts, m);
    // stb_truetype's conversion to moves, lines and quadratic curves, with
    // its integer midpoints between two off-curve points
    int32_t sx = 0, sy = 0, cx = 0, cy = 0, scx = 0, scy = 0;
    int was_off = 0, start_off = 0, next_move = 0, j = 0;
    for (int i = 0; i < n; ++i) {
      int32_t x = (int16_t)xs[i], y = (int16_t)ys[i];
      if (next_move == i) {
        if (i != 0) close_shape(out, was_off, start_off, sx, sy, scx, scy, cx, cy);
        start_off = !(flags[i] & 1);
        if (start_off) {
          scx = x;
          scy = y;
          if (i + 1 < n && !(flags[i + 1] & 1)) {
            sx = (x + (int16_t)xs[i + 1]) >> 1;
            sy = (y + (int16_t)ys[i + 1]) >> 1;
          } else if (i + 1 < n) {
            sx = (int16_t)xs[i + 1];
            sy = (int16_t)ys[i + 1];
            ++i;
          }
        } else {
          sx = x;
          sy = y;
        }
        out.push_back(vertex(V_MOVE, sx, sy, 0, 0));
        was_off = 0;
        next_move = 1 + endpts[j++];
      } else if (!(flags[i] & 1)) {
        if (was_off) out.push_back(vertex(V_CURVE, (cx + x) >> 1, (cy + y) >> 1, cx, cy));
        cx = x;
        cy = y;
        was_off = 1;
      } else {
        out.push_back(was_off ? vertex(V_CURVE, x, y, cx, cy) : vertex(V_LINE, x, y, 0, 0));
        was_off = 0;
      }
    }
    close_shape(out, was_off, start_off, sx, sy, scx, scy, cx, cy);
    return true;
  }
  if (nc < 0) {
    // components: their offsets are the "points" gvar moves
    struct Comp {
      int glyph;
      float mtx[6];
    };
    std::vector<Comp> comps;
    const uint8_t* c = d + 10;
    for (int more = 1; more;) {
      if (c + 4 > dend) return false;
      int fl = u16(c), gi = u16(c + 2);
      c += 4;
      Comp k{gi, {1, 0, 0, 1, 0, 0}};
      if (!(fl & 2)) return false;  // matched points: stb_truetype has none
      if (fl & 1) {
        k.mtx[4] = i16(c);
        k.mtx[5] = i16(c + 2);
        c += 4;
      } else {
        k.mtx[4] = i8(c);
        k.mtx[5] = i8(c + 1);
        c += 2;
      }
      if (fl & (1 << 3)) {
        k.mtx[0] = k.mtx[3] = i16(c) / 16384.0f;
        k.mtx[1] = k.mtx[2] = 0;
        c += 2;
      } else if (fl & (1 << 6)) {
        k.mtx[0] = i16(c) / 16384.0f;
        k.mtx[1] = k.mtx[2] = 0;
        k.mtx[3] = i16(c + 2) / 16384.0f;
        c += 4;
      } else if (fl & (1 << 7)) {
        k.mtx[0] = i16(c) / 16384.0f;
        k.mtx[1] = i16(c + 2) / 16384.0f;
        k.mtx[2] = i16(c + 4) / 16384.0f;
        k.mtx[3] = i16(c + 6) / 16384.0f;
        c += 8;
      }
      comps.push_back(k);
      more = fl & (1 << 5);
    }
    int n = (int)comps.size();
    std::vector<int> xs(n + 4), ys(n + 4);
    for (int i = 0; i < n; ++i) {
      xs[i] = (int)comps[i].mtx[4];
      ys[i] = (int)comps[i].mtx[5];
    }
    xs[n] = xmin - lsb;
    xs[n + 1] = xs[n] + adv;
    vary(f, g, xs, ys, {}, m);
    std::vector<Vertex> cv;
    for (int i = 0; i < n; ++i) {
      float* mtx = comps[i].mtx;
      mtx[4] = (float)(int16_t)xs[i];
      mtx[5] = (float)(int16_t)ys[i];
      // stb_truetype's scales, and its float-to-short truncation
      float mx = (float)std::sqrt(mtx[0] * mtx[0] + mtx[1] * mtx[1]);
      float my = (float)std::sqrt(mtx[2] * mtx[2] + mtx[3] * mtx[3]);
      if (!glyph_shape(f, comps[i].glyph, cv, nullptr, depth + 1)) return false;
      for (Vertex& v : cv) {
        int16_t x = v.x, y = v.y;
        v.x = (int16_t)(mx * (mtx[0] * x + mtx[2] * y + mtx[4]));
        v.y = (int16_t)(my * (mtx[1] * x + mtx[3] * y + mtx[5]));
        x = v.cx;
        y = v.cy;
        v.cx = (int16_t)(mx * (mtx[0] * x + mtx[2] * y + mtx[4]));
        v.cy = (int16_t)(my * (mtx[1] * x + mtx[3] * y + mtx[5]));
      }
      out.insert(out.end(), cv.begin(), cv.end());
    }
  }
  return true;
}

// ---------------------------------------------------------------- raster

struct Point {
  float x, y;
};

void tesselate_curve(std::vector<Point>& pts, float x0, float y0, float x1, float y1, float x2,
                     float y2, float flat2, int n) {
  float mx = (x0 + 2 * x1 + x2) / 4;
  float my = (y0 + 2 * y1 + y2) / 4;
  float dx = (x0 + x2) / 2 - mx;
  float dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flat2) {
    tesselate_curve(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flat2, n + 1);
    tesselate_curve(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flat2, n + 1);
  } else {
    pts.push_back({x2, y2});
  }
}

void flatten(const std::vector<Vertex>& v, float flatness, std::vector<Point>& pts,
             std::vector<int>& lengths) {
  float flat2 = flatness * flatness;
  pts.clear();
  lengths.clear();
  float x = 0, y = 0;
  int start = 0;
  for (const Vertex& t : v) {
    switch (t.type) {
      case V_MOVE:
        if (!lengths.empty() || !pts.empty()) lengths.push_back((int)pts.size() - start);
        start = (int)pts.size();
        x = t.x, y = t.y;
        pts.push_back({x, y});
        break;
      case V_LINE:
        x = t.x, y = t.y;
        pts.push_back({x, y});
        break;
      case V_CURVE:
        tesselate_curve(pts, x, y, t.cx, t.cy, t.x, t.y, flat2, 0);
        x = t.x, y = t.y;
        break;
    }
  }
  if (!pts.empty()) lengths.push_back((int)pts.size() - start);
}

struct Edge {
  float x0, y0, x1, y1;
  int invert;
};

inline bool edge_less(const Edge* a, const Edge* b) { return a->y0 < b->y0; }

void sort_edges_ins(Edge* p, int n) {
  for (int i = 1; i < n; ++i) {
    Edge t = p[i], *a = &t;
    int j = i;
    while (j > 0) {
      Edge* b = &p[j - 1];
      if (!edge_less(a, b)) break;
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

void sort_edges_quick(Edge* p, int n) {
  while (n > 12) {
    Edge t;
    int m = n >> 1;
    int c01 = edge_less(&p[0], &p[m]);
    int c12 = edge_less(&p[m], &p[n - 1]);
    if (c01 != c12) {
      int c = edge_less(&p[0], &p[n - 1]);
      int z = (c == c12) ? 0 : n - 1;
      t = p[z];
      p[z] = p[m];
      p[m] = t;
    }
    t = p[0];
    p[0] = p[m];
    p[m] = t;
    int i = 1, j = n - 1;
    for (;;) {
      for (;; ++i)
        if (!edge_less(&p[i], &p[0])) break;
      for (;; --j)
        if (!edge_less(&p[0], &p[j])) break;
      if (i >= j) break;
      t = p[i];
      p[i] = p[j];
      p[j] = t;
      ++i;
      --j;
    }
    if (j < (n - i)) {
      sort_edges_quick(p, j);
      p = p + i;
      n = n - i;
    } else {
      sort_edges_quick(p + i, n - i);
      n = j;
    }
  }
}

struct Active {
  Active* next;
  float fx, fdx, fdy;
  float direction;
  float sy, ey;
};

void handle_clipped_edge(float* scanline, int x, const Active* e, float x0, float y0, float x1,
                         float y1) {
  if (y0 == y1) return;
  if (y0 > e->ey) return;
  if (y1 < e->sy) return;
  if (y0 < e->sy) {
    x0 += (x1 - x0) * (e->sy - y0) / (y1 - y0);
    y0 = e->sy;
  }
  if (y1 > e->ey) {
    x1 += (x1 - x0) * (e->ey - y1) / (y1 - y0);
    y1 = e->ey;
  }
  if (x0 <= x && x1 <= x)
    scanline[x] += e->direction * (y1 - y0);
  else if (x0 >= x + 1 && x1 >= x + 1)
    ;
  else
    scanline[x] += e->direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

inline float sized_trapezoid_area(float height, float top_width, float bottom_width) {
  return (top_width + bottom_width) / 2.0f * height;
}

inline float position_trapezoid_area(float height, float tx0, float tx1, float bx0, float bx1) {
  return sized_trapezoid_area(height, tx1 - tx0, bx1 - bx0);
}

inline float sized_triangle_area(float height, float width) { return height * width / 2; }

void fill_active_edges(float* scanline, float* scanline_fill, int len, Active* e, float y_top) {
  float y_bottom = y_top + 1;
  while (e) {
    if (e->fdx == 0) {
      float x0 = e->fx;
      if (x0 < len) {
        if (x0 >= 0) {
          handle_clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
          handle_clipped_edge(scanline_fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
        } else {
          handle_clipped_edge(scanline_fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
    } else {
      float x0 = e->fx;
      float dx = e->fdx;
      float xb = x0 + dx;
      float x_top, x_bottom;
      float sy0, sy1;
      float dy = e->fdy;
      if (e->sy > y_top) {
        x_top = x0 + dx * (e->sy - y_top);
        sy0 = e->sy;
      } else {
        x_top = x0;
        sy0 = y_top;
      }
      if (e->ey < y_bottom) {
        x_bottom = x0 + dx * (e->ey - y_top);
        sy1 = e->ey;
      } else {
        x_bottom = xb;
        sy1 = y_bottom;
      }
      if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
        if ((int)x_top == (int)x_bottom) {
          int x = (int)x_top;
          float height = (sy1 - sy0) * e->direction;
          scanline[x] += position_trapezoid_area(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
          scanline_fill[x] += height;
        } else {
          if (x_top > x_bottom) {
            float t;
            sy0 = y_bottom - (sy0 - y_top);
            sy1 = y_bottom - (sy1 - y_top);
            t = sy0, sy0 = sy1, sy1 = t;
            t = x_bottom, x_bottom = x_top, x_top = t;
            dx = -dx;
            dy = -dy;
            t = x0, x0 = xb, xb = t;
          }
          int x1 = (int)x_top;
          int x2 = (int)x_bottom;
          float y_crossing = y_top + dy * (x1 + 1 - x0);
          float y_final = y_top + dy * (x2 - x0);
          if (y_crossing > y_bottom) y_crossing = y_bottom;
          float sign = e->direction;
          float area = sign * (y_crossing - sy0);
          scanline[x1] += sized_triangle_area(area, x1 + 1 - x_top);
          if (y_final > y_bottom) {
            int denom = (x2 - (x1 + 1));
            y_final = y_bottom;
            if (denom != 0) dy = (y_final - y_crossing) / denom;
          }
          float step = sign * dy * 1;
          for (int x = x1 + 1; x < x2; ++x) {
            scanline[x] += area + step / 2;
            area += step;
          }
          scanline[x2] += area + sign * position_trapezoid_area(sy1 - y_final, (float)x2,
                                                                 x2 + 1.0f, x_bottom, x2 + 1.0f);
          scanline_fill[x2] += sign * (sy1 - sy0);
        }
      } else {
        for (int x = 0; x < len; ++x) {
          float y0 = y_top;
          float x1 = (float)(x);
          float x2 = (float)(x + 1);
          float x3 = xb;
          float y3 = y_bottom;
          float y1 = (x - x0) / dx + y_top;
          float y2 = (x + 1 - x0) / dx + y_top;
          if (x0 < x1 && x3 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
          } else if (x3 < x1 && x0 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
          } else if (x0 < x1 && x3 > x1) {
            handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
          } else if (x3 < x1 && x0 > x1) {
            handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
          } else if (x0 < x2 && x3 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
          } else if (x3 < x2 && x0 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
          } else {
            handle_clipped_edge(scanline, x, e, x0, y0, x3, y3);
          }
        }
      }
    }
    e = e->next;
  }
}

// the coverage of w x h pixels whose top left is (off_x, off_y), from edges
// sorted by their top
void rasterize_sorted_edges(uint8_t* pixels, int w, int h, int stride, Edge* e, int n, int off_x,
                            int off_y) {
  std::vector<Active> pool;
  pool.reserve(n);
  Active* active = nullptr;
  std::vector<float> buf(2 * w + 1);
  float* scanline = buf.data();
  float* scanline2 = scanline + w;
  int y = off_y, j = 0;
  e[n].y0 = (float)(off_y + h) + 1;
  while (j < h) {
    float scan_y_top = y + 0.0f;
    float scan_y_bottom = y + 1.0f;
    Active** step = &active;
    memset(scanline, 0, w * sizeof(float));
    memset(scanline2, 0, (w + 1) * sizeof(float));
    while (*step) {
      Active* z = *step;
      if (z->ey <= scan_y_top)
        *step = z->next;
      else
        step = &((*step)->next);
    }
    while (e->y0 <= scan_y_bottom) {
      if (e->y0 != e->y1) {
        pool.push_back(Active());
        Active* z = &pool.back();
        float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
        z->fdx = dxdy;
        z->fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
        z->fx = e->x0 + dxdy * (scan_y_top - e->y0);
        z->fx -= off_x;
        z->direction = e->invert ? 1.0f : -1.0f;
        z->sy = e->y0;
        z->ey = e->y1;
        if (j == 0 && off_y != 0 && z->ey < scan_y_top) z->ey = scan_y_top;
        z->next = active;
        active = z;
      }
      ++e;
    }
    if (active) fill_active_edges(scanline, scanline2 + 1, w, active, scan_y_top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += scanline2[i];
      float k = scanline[i] + sum;
      k = (float)std::fabs(k) * 255 + 0.5f;
      int m = (int)k;
      if (m > 255) m = 255;
      pixels[j * stride + i] = (uint8_t)m;
    }
    for (Active* z = active; z; z = z->next) z->fx += z->fdx;
    ++y;
    ++j;
  }
}

void rasterize(uint8_t* pixels, int w, int h, int stride, const std::vector<Point>& pts,
               const std::vector<int>& lengths, float scale_x, float scale_y, float shift_x,
               float shift_y, int off_x, int off_y) {
  float y_scale_inv = -scale_y;
  int total = 0;
  for (int l : lengths) total += l;
  std::vector<Edge> e(total + 1);
  int n = 0, m = 0;
  for (int l : lengths) {
    const Point* p = pts.data() + m;
    m += l;
    int j = l - 1;
    for (int k = 0; k < l; j = k++) {
      int a = k, b = j;
      if (p[j].y == p[k].y) continue;
      e[n].invert = 0;
      if (p[j].y > p[k].y) {
        e[n].invert = 1;
        a = j, b = k;
      }
      e[n].x0 = p[a].x * scale_x + shift_x;
      e[n].y0 = (p[a].y * y_scale_inv + shift_y) * 1;
      e[n].x1 = p[b].x * scale_x + shift_x;
      e[n].y1 = (p[b].y * y_scale_inv + shift_y) * 1;
      ++n;
    }
  }
  sort_edges_quick(e.data(), n);
  sort_edges_ins(e.data(), n);
  rasterize_sorted_edges(pixels, w, h, stride, e.data(), n, off_x, off_y);
}

// ---------------------------------------------------------------- glyphs

// glyph g at scale (pixels per font unit), as OpenCV renders it into its
// cache: stb_truetype's box of the metrics' box, widened on every side by a
// margin of a tenth of its larger side plus 10 pixels (which enters the
// edges' float coordinates as the shift), rasterised at the flatness 0.35
// pixels, then cropped to its nonzero pixels. The advance is the metrics'
// times the scale in 26.6 fixed point, rounded, then truncated to pixels.
bool place_glyph(const Font& f, int g, float scale, Placed& out) {
  std::vector<Vertex> v;
  Metrics m;
  if (!glyph_shape(f, g, v, &m)) return false;
  out = Placed();
  out.advance = (int)std::lrint(64.0f * ((float)m.advance * scale)) >> 6;
  if (v.empty()) return true;
  int ix0 = (int)std::floor(m.box[0] * scale);
  int iy0 = (int)std::floor(-m.box[3] * scale);
  int ix1 = (int)std::ceil(m.box[2] * scale);
  int iy1 = (int)std::ceil(-m.box[1] * scale);
  int w = ix1 - ix0, h = iy1 - iy0;
  if (w <= 0 || h <= 0) return true;
  int pad = std::max((h + 9) / 10, (w + 9) / 10) + 10;
  int bw = w + 2 * pad, bh = h + 2 * pad;
  std::vector<uint8_t> px((size_t)bw * bh, 0);
  std::vector<Point> pts;
  std::vector<int> lengths;
  flatten(v, 0.35f / scale, pts, lengths);
  rasterize(px.data(), bw, bh, bw, pts, lengths, scale, scale, (float)pad, (float)pad, ix0, iy0);
  int x0 = bw, x1 = -1, y0 = bh, y1 = -1;
  for (int y = 0; y < bh; ++y)
    for (int x = 0; x < bw; ++x)
      if (px[(size_t)y * bw + x]) {
        x0 = std::min(x0, x);
        x1 = std::max(x1, x);
        y0 = std::min(y0, y);
        y1 = std::max(y1, y);
      }
  if (x1 < 0) return true;
  out.left = ix0 - pad + x0;
  out.top = iy0 - pad + y0;
  out.w = x1 - x0 + 1;
  out.h = y1 - y0 + 1;
  out.px.resize((size_t)out.w * out.h);
  for (int y = 0; y < out.h; ++y)
    memcpy(&out.px[(size_t)y * out.w], &px[(size_t)(y0 + y) * bw + x0], out.w);
  return true;
}

// the instance at a weight: its normalised coordinate, rounded to F2DOT14
// before and after avar's map
void set_weight(Font& f, int weight) {
  f.coords.assign(f.axis_count, 0);
  if (f.wght_axis < 0) return;
  int a = f.wght_axis;
  float v = std::min(std::max((float)weight, f.axis_min[a]), f.axis_max[a]), d = f.axis_def[a];
  float c = v < d ? (v - d) / (d - f.axis_min[a]) : v > d ? (v - d) / (f.axis_max[a] - d) : 0.0f;
  c = std::round(c * 16384.0f) / 16384.0f;
  if (f.avar) {
    const uint8_t* p = f.at(f.avar) + 8;
    for (int k = 0; k < a; ++k) p += 2 + 4 * u16(p);
    int n = u16(p);
    const uint8_t* map = p + 2;
    for (int k = 1; k < n; ++k) {
      float a0 = f2dot14(map + 4 * (k - 1)), b0 = f2dot14(map + 4 * (k - 1) + 2);
      float a1 = f2dot14(map + 4 * k), b1 = f2dot14(map + 4 * k + 2);
      if (c <= a1) {
        c = a1 == a0 ? b1 : b0 + (c - a0) * (b1 - b0) / (a1 - a0);
        break;
      }
    }
  }
  f.coords[a] = (int)std::lrint(c * 16384.0f);
}

// the glyphs of a text at a pixel size and weight, each codepoint outside
// the font's cmap as '?'; the caller holds f.lock
bool layout(Font& f, const uint32_t* cps, int n, int size, int weight,
            std::vector<const Placed*>& out) {
  float scale = (float)size / f.ascent;
  int question = glyph_index(f, '?');
  bool instance = false;
  out.resize(n);
  for (int i = 0; i < n; ++i) {
    int g = glyph_index(f, cps[i]);
    if (g == 0) g = question;
    auto key = std::make_tuple(g, size, weight);
    auto it = f.cache.find(key);
    if (it == f.cache.end()) {
      if (!instance) {
        set_weight(f, weight);
        instance = true;
      }
      Placed p;
      if (!place_glyph(f, g, scale, p)) return false;
      it = f.cache.emplace(key, std::move(p)).first;
    }
    out[i] = &it->second;
  }
  return true;
}

}  // namespace

extern "C" {

// the font in data (a TrueType file), or null when a table it needs is
// missing
void* yolov6_tt_open(const uint8_t* data, size_t len) {
  Font* f = new Font();
  f->data.assign(data, data + len);
  f->cmap = find_table(*f, "cmap");
  f->head = find_table(*f, "head");
  f->hhea = find_table(*f, "hhea");
  f->hmtx = find_table(*f, "hmtx");
  f->maxp = find_table(*f, "maxp");
  f->loca = find_table(*f, "loca");
  f->glyf = find_table(*f, "glyf");
  if (!f->cmap || !f->head || !f->hhea || !f->hmtx || !f->maxp || !f->loca || !f->glyf) {
    delete f;
    return nullptr;
  }
  f->glyf_len = table_len(*f, "glyf");
  f->num_glyphs = u16(f->at(f->maxp + 4));
  f->index_to_loc = i16(f->at(f->head + 50));
  f->ascent = i16(f->at(f->hhea + 4));
  f->num_hmetrics = u16(f->at(f->hhea + 34));
  // the Unicode subtable: format 12 where there is one, else format 4
  int n = u16(f->at(f->cmap + 2));
  for (int i = 0; i < n; ++i) {
    const uint8_t* r = f->at(f->cmap + 4 + 8 * i);
    int pid = u16(r), eid = u16(r + 2);
    uint32_t off = f->cmap + u32(r + 4);
    int fmt = u16(f->at(off));
    if (((pid == 3 && (eid == 1 || eid == 10)) || pid == 0) &&
        (fmt == 12 || (fmt == 4 && f->cmap_format != 12))) {
      f->cmap_sub = off;
      f->cmap_format = fmt;
    }
  }
  if (!f->cmap_format || f->ascent <= 0) {
    delete f;
    return nullptr;
  }
  f->fvar = find_table(*f, "fvar");
  if (f->fvar) {
    const uint8_t* fv = f->at(f->fvar);
    f->axis_count = u16(fv + 8);
    int axis_size = u16(fv + 10);
    const uint8_t* ax = fv + u16(fv + 4);
    for (int a = 0; a < f->axis_count; ++a) {
      const uint8_t* r = ax + a * axis_size;
      if (memcmp(r, "wght", 4) == 0) f->wght_axis = a;
      f->axis_min.push_back(i32(r + 4) / 65536.0f);
      f->axis_def.push_back(i32(r + 8) / 65536.0f);
      f->axis_max.push_back(i32(r + 12) / 65536.0f);
    }
    f->avar = find_table(*f, "avar");
    f->gvar = find_table(*f, "gvar");
    f->gvar_len = table_len(*f, "gvar");
  }
  return f;
}

void yolov6_tt_close(void* h) { delete (Font*)h; }

// cv2.getTextSize's (w, h, baseline) of the n codepoints cps at the pixel
// size and weight into out: 1 + the advances, the size, and the lowest
// glyph's depth below the baseline; (0, 0, 0) for no text. Returns 0 on a
// broken glyph.
int yolov6_tt_text_size(void* h, const uint32_t* cps, int n, int size, int weight, int* out) {
  Font& f = *(Font*)h;
  out[0] = out[1] = out[2] = 0;
  if (n <= 0) return 1;
  std::lock_guard<std::mutex> hold(f.lock);
  std::vector<const Placed*> gl;
  if (!layout(f, cps, n, size, weight, gl)) return 0;
  int w = 1, bottom = 0;
  for (const Placed* p : gl) {
    w += p->advance;
    if (p->w) bottom = std::max(bottom, p->top + p->h);
  }
  out[0] = w;
  out[1] = size;
  out[2] = bottom;
  return 1;
}

// cv2.putText: the glyphs of cps blended one after another into the rows x
// cols image of ch uint8 channels (step bytes a row), the first glyph's pen
// at x on the baseline y; a pixel under coverage a becomes
// (color * a + pixel * (255 - a) + 127) / 255. Returns 0 on a broken glyph.
int yolov6_tt_put_text(void* h, uint8_t* img, int rows, int cols, int ch, long step,
                       const uint32_t* cps, int n, int x, int y, int size, int weight,
                       const int* color) {
  Font& f = *(Font*)h;
  if (n <= 0) return 1;
  std::lock_guard<std::mutex> hold(f.lock);
  std::vector<const Placed*> gl;
  if (!layout(f, cps, n, size, weight, gl)) return 0;
  int pen = x;
  for (const Placed* p : gl) {
    int gx = pen + p->left, gy = y + p->top;
    for (int r = std::max(0, -gy); r < p->h && gy + r < rows; ++r) {
      uint8_t* row = img + (long)(gy + r) * step;
      const uint8_t* a = &p->px[(size_t)r * p->w];
      for (int c = std::max(0, -gx); c < p->w && gx + c < cols; ++c) {
        int al = a[c];
        if (!al) continue;
        uint8_t* px = row + (long)(gx + c) * ch;
        for (int k = 0; k < ch; ++k)
          px[k] = (uint8_t)((color[k] * al + px[k] * (255 - al) + 127) / 255);
      }
    }
    pen += p->advance;
  }
  return 1;
}

}  // extern "C"
