"""A small raster plotter in numpy for the evaluation plots, in place of the
matplotlib figure the JAX package draws them on (``_agg_axes``,
yolov6_tpu/utils/metrics.py:79-86: ``figsize=(9, 6)`` saved at ``dpi=250``).
The machine with the card has no matplotlib.

``Axes`` is one figure with one axes box on a 2250x1500 RGB canvas:

- ``plot(x, y, linewidth, color, label)`` takes matplotlib's arguments (a
  2-D ``y`` is one line a column) and draws polylines of ``linewidth``
  points (1 pt = 250 / 72 px) in data coordinates, x and y in [0, 1],
  clipped to the axes box. A line without a colour takes the next of
  matplotlib's default cycle (the ten tab10 colours); ``"grey"`` is #808080
  and ``"blue"`` #0000ff, as in matplotlib. ``lines`` keeps what was drawn.
- ``legend()`` lists the labelled lines to the right of the box, as
  ``bbox_to_anchor=(1.04, 1), loc="upper left"`` places it.
- ``imshow(m, vmin=0, vmax=1)`` fills a square box with ``m``'s cells in
  the ``"Blues"`` colormap (``BLUES``: 256 entries interpolated, as
  matplotlib's ``LinearSegmentedColormap`` does, from ColorBrewer's nine
  control points, and truncated to bytes as its ``bytes=True`` does); NaN
  cells stay white. ``colorbar()`` draws the scale beside it, ``text``
  writes in a cell's centre.
- Ticks at 0, 0.2, ... 1 (or the cells' centres), tick labels and axis
  labels, in the port's 5x7 font (utils/draw.py).
- ``savefig(path)`` writes the PNG (data/image_io.py::imwrite_png).

The data, colours and strings are matplotlib's; the pixels are not (no
anti-aliasing, another font, another layout).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from yolov6_tpu_torch.data.image_io import imwrite_png
from yolov6_tpu_torch.utils.draw import get_text_size, put_text

DPI = 250
FIG_W, FIG_H = 9 * DPI, 6 * DPI
PT = DPI / 72.0  # pixels a point
TAB10 = ("1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd", "8c564b", "e377c2", "7f7f7f",
         "bcbd22", "17becf")
NAMED = {"grey": "808080", "blue": "0000ff", "black": "000000", "white": "ffffff"}
# ColorBrewer's sequential Blues, the nine points of matplotlib's _Blues_data
BLUES_POINTS = ("f7fbff", "deebf7", "c6dbef", "9ecae1", "6baed6", "4292c6", "2171b5",
                "08519c", "08306b")


def _rgb(hexstr: str):
    return tuple(int(hexstr[i:i + 2], 16) for i in (0, 2, 4))


def _blues() -> np.ndarray:
    """matplotlib's ``LinearSegmentedColormap.from_list`` table of 256 over
    the nine points, and its ``bytes=True`` truncation."""
    pts = np.array([_rgb(h) for h in BLUES_POINTS], np.float64) / 255.0
    x = np.linspace(0.0, 1.0, len(pts)) * 255
    xind = 255 * np.linspace(0.0, 1.0, 256)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = ((xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1]))[:, None]
    lut = np.concatenate([pts[:1], distance * (pts[ind] - pts[ind - 1]) + pts[ind - 1],
                          pts[-1:]])
    return (np.clip(lut, 0.0, 1.0) * 255).astype(np.uint8)


BLUES = _blues()  # [256, 3] uint8 RGB


def to_rgb(color: str) -> tuple:
    """A colour name of ``NAMED`` -> RGB bytes."""
    return _rgb(NAMED[color])


def blues_index(v: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> rows of ``BLUES``, as matplotlib's colormap
    indexes its table (``int(v * 256)``, 1.0 to the last row)."""
    return np.clip((np.asarray(v, np.float64) * 256).astype(np.int64), 0, 255)


def _disc(radius: float) -> np.ndarray:
    r = int(np.ceil(radius))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dy * dy + dx * dx <= radius * radius
    return np.stack([dy[keep], dx[keep]], 1)


def _text_mask(text: str, scale: float, thickness: int) -> np.ndarray:
    """The pixels ``put_text`` writes for ``text``, as a bool [h, w] block
    whose bottom row is the baseline."""
    w, h = get_text_size(text, scale, thickness)
    buf = np.zeros((h + 1, max(w, 1), 3), np.uint8)
    put_text(buf, text, (0, h), scale, (255, 255, 255), thickness)
    return buf[..., 0] > 0


class Axes:
    """One axes on a 2250x1500 canvas (module doc). ``box`` is the axes'
    pixel box ``(x0, y0, x1, y1)``, ``y0`` the top."""

    TICK_SCALE, LABEL_SCALE, LEGEND_SCALE = 1.0, 1.4, 1.0

    def __init__(self, box=(200, 70, 1560, 1320)):
        self.img = np.full((FIG_H, FIG_W, 3), 255, np.uint8)
        self.box = box
        self.lines = []  # each: {"x", "y", "linewidth", "color" (RGB), "label"}
        self._cycle = 0
        self._texts = []  # deferred cell texts
        self.xlabel = self.ylabel = ""
        self.xticks = self.yticks = None
        self.xticklabels = self.yticklabels = None
        self.image = None
        self._colorbar = False
        self._legend = False

    # ------------------------------------------------------------ transforms

    def to_pixel(self, x, y):
        """Data (x, y) in [0, 1] -> pixel (column, row) as floats."""
        x0, y0, x1, y1 = self.box
        return x0 + np.asarray(x, np.float64) * (x1 - x0), y1 - np.asarray(y, np.float64) * (y1 - y0)

    def cell_box(self, i: int, j: int):
        """``imshow``'s cell (row i, column j) as pixel bounds ``(r0, r1, c0,
        c1)``, ends exclusive."""
        n_r, n_c = self.image.shape
        x0, y0, x1, y1 = self.box
        rs = np.rint(np.linspace(y0, y1, n_r + 1)).astype(int)
        cs = np.rint(np.linspace(x0, x1, n_c + 1)).astype(int)
        return rs[i], rs[i + 1], cs[j], cs[j + 1]

    # ----------------------------------------------------------- matplotlib

    def plot(self, x, y, linewidth: float = 1.5, color=None, label: Optional[str] = None):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        cols = y.reshape(len(y), -1).T if y.ndim > 1 else y[None]
        for col in cols:
            if color is None:
                rgb = _rgb(TAB10[self._cycle % len(TAB10)])
                self._cycle += 1
            else:
                rgb = to_rgb(color)
            self.lines.append(dict(x=x, y=col, linewidth=float(linewidth), color=rgb,
                                   label=label))

    def set_xlabel(self, text: str) -> None:
        self.xlabel = text

    def set_ylabel(self, text: str) -> None:
        self.ylabel = text

    def set_xlim(self, lo, hi) -> None:
        if (lo, hi) != (0, 1):
            raise ValueError("the raster axes span [0, 1]")

    set_ylim = set_xlim

    def legend(self) -> None:
        self._legend = True

    def imshow(self, m, vmin: float = 0.0, vmax: float = 1.0) -> None:
        if (vmin, vmax) != (0.0, 1.0):
            raise ValueError("imshow maps [0, 1] onto Blues")
        self.image = np.asarray(m, np.float64)
        n_r, n_c = self.image.shape
        x0, y0, x1, y1 = self.box
        side = min(x1 - x0, y1 - y0)  # aspect 'equal'
        cell = side / max(n_r, n_c)
        self.box = (x0, y0, x0 + int(round(cell * n_c)), y0 + int(round(cell * n_r)))

    def colorbar(self) -> None:
        self._colorbar = True

    def set_xticks(self, ticks) -> None:
        self.xticks = list(ticks)

    def set_yticks(self, ticks) -> None:
        self.yticks = list(ticks)

    def set_xticklabels(self, labels) -> None:
        self.xticklabels = [str(s) for s in labels]

    def set_yticklabels(self, labels) -> None:
        self.yticklabels = [str(s) for s in labels]

    def text(self, x, y, s: str, color="black") -> None:
        """``s`` centred on cell (row ``y``, column ``x``) of ``imshow``."""
        self._texts.append((int(x), int(y), s, to_rgb(color)))

    # ------------------------------------------------------------- drawing

    def _paste(self, mask: np.ndarray, top: int, left: int, color) -> None:
        H, W = self.img.shape[:2]
        h, w = mask.shape
        ya, xa = max(top, 0), max(left, 0)
        yb, xb = min(top + h, H), min(left + w, W)
        if ya < yb and xa < xb:
            self.img[ya:yb, xa:xb][mask[ya - top:yb - top, xa - left:xb - left]] = color

    def _label(self, text: str, cx: float, cy: float, scale: float, rotate: bool = False,
               color=(0, 0, 0), anchor: str = "center") -> None:
        """``text`` centred on (cx, cy), read bottom to top when ``rotate``;
        ``anchor`` 'left' or 'right' puts that end at cx, 'top' its top at
        cy."""
        mask = _text_mask(text, scale, 1 if scale < 1 else 2)
        if rotate:
            mask = np.rot90(mask)
        h, w = mask.shape
        left = {"left": cx, "right": cx - w}.get(anchor, cx - w / 2)
        top = cy if anchor == "top" else cy - h / 2
        self._paste(mask, int(round(top)), int(round(left)), color)

    def _stamp(self, x, y, width_px: float, color) -> None:
        """A polyline through pixel points (x, y), ``width_px`` wide, clipped to
        the axes box (its frame included)."""
        if len(x) == 0:
            return
        dx, dy = np.diff(x), np.diff(y)
        n = np.maximum(np.ceil(np.hypot(dx, dy) / 0.5).astype(np.int64), 1)
        seg = np.repeat(np.arange(len(n)), n)
        k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        t = k / n[seg]
        px = np.append(x[:-1][seg] + t * dx[seg], x[-1])
        py = np.append(y[:-1][seg] + t * dy[seg], y[-1])
        W = self.img.shape[1]
        flat = np.unique(np.rint(py).astype(np.int64) * W + np.rint(px).astype(np.int64))
        centres = np.stack([flat // W, flat % W], 1)
        pts = (centres[:, None, :] + _disc(width_px / 2)[None]).reshape(-1, 2)
        x0, y0, x1, y1 = self.box
        inside = (pts[:, 0] >= y0) & (pts[:, 0] <= y1) & (pts[:, 1] >= x0) & (pts[:, 1] <= x1)
        pts = pts[inside]
        self.img[pts[:, 0], pts[:, 1]] = color

    def _frame(self, xticks, yticks, xlabels, ylabels, rotate_x: bool) -> None:
        x0, y0, x1, y1 = self.box
        black = (0, 0, 0)
        self.img[y0 - 1:y0 + 2, x0 - 1:x1 + 2] = black
        self.img[y1 - 1:y1 + 2, x0 - 1:x1 + 2] = black
        self.img[y0 - 1:y1 + 2, x0 - 1:x0 + 2] = black
        self.img[y0 - 1:y1 + 2, x1 - 1:x1 + 2] = black
        for px, text in zip(xticks, xlabels):
            c = int(round(px))
            self.img[y1 + 2:y1 + 14, c - 1:c + 2] = black
            if text:
                self._label(text, c, y1 + 20, self.TICK_SCALE if not rotate_x else 0.8,
                            rotate=rotate_x, anchor="top" if rotate_x else "center")
        for py, text in zip(yticks, ylabels):
            r = int(round(py))
            self.img[r - 1:r + 2, x0 - 14:x0 - 2] = black
            if text:
                self._label(text, x0 - 22, r, self.TICK_SCALE if not rotate_x else 0.8,
                            anchor="right")

    def render(self) -> np.ndarray:
        x0, y0, x1, y1 = self.box
        if self.image is None:
            ticks = np.linspace(0.0, 1.0, 6)
            labels = [f"{v:.1f}" for v in ticks]
            tx, ty = self.to_pixel(ticks, ticks)
            self._frame(tx, ty, labels, labels, rotate_x=False)
            self._label(self.xlabel, (x0 + x1) / 2, y1 + 110, self.LABEL_SCALE)
            self._label(self.ylabel, x0 - 150, (y0 + y1) / 2, self.LABEL_SCALE, rotate=True)
            for line in self.lines:
                px, py = self.to_pixel(line["x"], line["y"])
                self._stamp(px, py, line["linewidth"] * PT, line["color"])
            if self._legend:
                self._draw_legend()
        else:
            self._draw_image()
        return self.img

    def _draw_legend(self) -> None:
        x0, y0, x1, _ = self.box
        left = int(round(x1 + 0.04 * (x1 - x0)))
        row = y0 + 30
        for line in self.lines:
            if not line["label"] or line["label"].startswith("_"):
                continue
            width = line["linewidth"] * PT
            r = int(np.ceil(width / 2))
            self.img[row - r:row + r + 1, left:left + 80] = line["color"]
            mask = _text_mask(line["label"], self.LEGEND_SCALE, 2)
            self._paste(mask, row - mask.shape[0] // 2, left + 100, (0, 0, 0))
            row += 48

    def _draw_image(self) -> None:
        m = self.image
        n_r, n_c = m.shape
        x0, y0, x1, y1 = self.box
        finite = np.isfinite(m)
        colors = BLUES[blues_index(np.where(finite, m, 0.0))]
        for i in range(n_r):
            for j in range(n_c):
                if finite[i, j]:
                    r0, r1, c0, c1 = self.cell_box(i, j)
                    self.img[r0:r1, c0:c1] = colors[i, j]
        for j, i, s, color in self._texts:
            r0, r1, c0, c1 = self.cell_box(i, j)
            self._label(s, (c0 + c1) / 2, (r0 + r1) / 2, min(1.0, (c1 - c0) / 90), color=color)
        rs = [sum(self.cell_box(i, 0)[:2]) / 2 for i in range(n_r)]
        cs = [sum(self.cell_box(0, j)[2:]) / 2 for j in range(n_c)]
        xt = [cs[k] for k in (self.xticks or [])]
        yt = [rs[k] for k in (self.yticks or [])]
        self._frame(xt, yt, self.xticklabels or [""] * len(xt),
                    self.yticklabels or [""] * len(yt), rotate_x=True)
        self._label(self.xlabel, (x0 + x1) / 2, min(y1 + 150, FIG_H - 30), self.LABEL_SCALE)
        self._label(self.ylabel, max(x0 - 190, 30), (y0 + y1) / 2, self.LABEL_SCALE,
                    rotate=True)
        if self._colorbar:
            cb0 = x1 + 40
            rows = np.arange(y0, y1 + 1)
            v = (y1 - rows) / max(y1 - y0, 1)
            self.img[y0:y1 + 1, cb0:cb0 + 60] = BLUES[blues_index(v)][:, None]
            self.img[y0 - 1:y1 + 2, cb0 - 1:cb0 + 1] = 0
            self.img[y0 - 1:y1 + 2, cb0 + 60:cb0 + 62] = 0
            self.img[y0 - 1:y0 + 1, cb0 - 1:cb0 + 62] = 0
            self.img[y1:y1 + 2, cb0 - 1:cb0 + 62] = 0
            for t in np.linspace(0.0, 1.0, 6):
                r = int(round(y1 - t * (y1 - y0)))
                self.img[r - 1:r + 2, cb0 + 62:cb0 + 74] = 0
                self._label(f"{t:.1f}", cb0 + 80, r, self.TICK_SCALE, anchor="left")

    def savefig(self, path: str) -> None:
        imwrite_png(path, self.render()[:, :, ::-1])  # imwrite_png takes BGR

