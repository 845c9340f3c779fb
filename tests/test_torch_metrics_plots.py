"""The port's evaluation plots (yolov6_tpu_torch/utils/{metrics,plots}.py)
against the JAX package's matplotlib plots (yolov6_tpu/utils/metrics.py).

The port rasterises its own figure, so the pixels differ; what must agree is
what each hands to its axes: every curve's x and y (exact), its line width,
its colour (matplotlib's, resolved to RGB) and its legend string, for 3
classes (coloured, labelled curves) and 25 (grey curves, one legend entry);
``ap_per_class``'s values (1e-12, as tests/test_torch_coco_eval.py); the
confusion matrix (exact). On the port's PNGs (2250x1500, figsize (9, 6) at
dpi 250): the mean curve's pixels are blue, the heatmap's cells have the
Blues colour of their value at their corners, and the Blues table equals
matplotlib's within 1/255 (and its ``bytes=True`` table exactly)."""

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import matplotlib

matplotlib.use("Agg")
import matplotlib.axes  # noqa: E402
import matplotlib.colors  # noqa: E402

from yolov6_tpu.utils import metrics as jax_metrics  # noqa: E402

from yolov6_tpu_torch.data.image_io import imread  # noqa: E402
from yolov6_tpu_torch.utils import metrics, plots  # noqa: E402

TOL = dict(rtol=0, atol=1e-12)
CURVES = ("PR_curve", "F1_curve", "P_curve", "R_curve")


def _stats(nc, seed, n=900):
    rng = np.random.default_rng(seed)
    conf = rng.random(n)
    pred_cls = rng.integers(0, nc, n).astype(np.float64)
    tp = rng.random((n, 10)) < (0.2 + 0.6 * conf[:, None]) * np.linspace(1, 0.4, 10)[None]
    target_cls = np.concatenate([rng.integers(0, nc, 300), np.arange(nc)]).astype(np.float64)
    return tp, conf, pred_cls, target_cls


@pytest.fixture
def recorded(monkeypatch):
    """Every line handed to matplotlib's and to the port's axes, in order:
    (x, y, linewidth, RGB, label)."""
    calls = {"jax": [], "port": [], "axes": []}
    mpl_plot, port_plot = matplotlib.axes.Axes.plot, plots.Axes.plot

    def jax_spy(self, x, y, **kw):
        lines = mpl_plot(self, x, y, **kw)
        for line in lines:
            rgb = tuple(int(round(c * 255)) for c in matplotlib.colors.to_rgb(line.get_color()))
            calls["jax"].append((np.asarray(line.get_xdata()), np.asarray(line.get_ydata()),
                                 line.get_linewidth(), rgb, kw.get("label")))
        return lines

    def port_spy(self, x, y, **kw):
        n = len(self.lines)
        port_plot(self, x, y, **kw)
        calls["port"] += [(ln["x"], ln["y"], ln["linewidth"], ln["color"], ln["label"])
                          for ln in self.lines[n:]]
        if not calls["axes"] or calls["axes"][-1] is not self:
            calls["axes"].append(self)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", jax_spy)
    monkeypatch.setattr(plots.Axes, "plot", port_spy)
    return calls


@pytest.mark.parametrize("nc", [3, 25], ids=["3_classes_coloured", "25_classes_grey"])
def test_curves_hand_matplotlibs_series(nc, recorded, tmp_path):
    args = _stats(nc, seed=nc)
    names = tuple(f"class{i}" for i in range(nc))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    theirs = jax_metrics.ap_per_class(*args, plot=True, save_dir=str(tmp_path / "jax"),
                                      names=names)
    ours = metrics.ap_per_class(*args, plot=True, save_dir=str(tmp_path / "port"), names=names)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, **TOL)
    for name in CURVES:
        assert imread(str(tmp_path / "port" / f"{name}.png")).shape == (1500, 2250, 3)
    jax_lines, port_lines = recorded["jax"], recorded["port"]
    assert len(port_lines) == len(jax_lines) == 4 * (nc + 1)
    for (x, y, lw, rgb, label), (xj, yj, lwj, rgbj, labelj) in zip(port_lines, jax_lines):
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)
        assert (lw, rgb, label) == (lwj, rgbj, labelj)
    labels = [ln[4] for ln in port_lines if ln[4]]
    if nc < 21:
        assert labels[0].startswith("class0 ") and len(set(ln[3] for ln in port_lines)) == nc + 1
    else:
        assert {ln[3] for ln in port_lines[:nc]} == {(128, 128, 128)} and len(labels) == 4
    assert all(ln[3] == (0, 0, 255) and ln[2] == 3 for ln in port_lines[nc::nc + 1])

    # the mean curve (drawn last, blue) at 20 points along it, inside the box
    ax = recorded["axes"][0]
    x, y = port_lines[nc][:2]
    inner = np.flatnonzero((y > 0.02) & (y < 0.98) & (x > 0.02) & (x < 0.98))
    cols, rows = ax.to_pixel(x, y)
    for i in inner[np.linspace(0, len(inner) - 1, 20).astype(int)]:
        assert tuple(ax.img[int(round(rows[i])), int(round(cols[i]))]) == (0, 0, 255), i


def test_confusion_matrix_plot(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    cm, cm_j = metrics.ConfusionMatrix(nc=3), jax_metrics.ConfusionMatrix(nc=3)
    for _ in range(8):
        xy = rng.uniform(0, 200, (6, 2))
        gt = np.concatenate([rng.integers(0, 3, (6, 1)), xy, xy + rng.uniform(10, 60, (6, 2))],
                            1).astype(np.float32)
        dxy = np.concatenate([gt[:, 1:3], rng.uniform(0, 200, (3, 2))]) + rng.normal(0, 3, (9, 2))
        det = np.concatenate([dxy, dxy + rng.uniform(10, 60, (9, 2)), rng.uniform(0, 1, (9, 1)),
                              rng.integers(0, 3, (9, 1))], 1).astype(np.float32)
        cm.process_batch(det, gt)
        cm_j.process_batch(det, gt)
    np.testing.assert_array_equal(cm.matrix, cm_j.matrix)
    cm_j.plot(save_dir=str(tmp_path), names=("a", "b", "c"))
    saved = []
    real_savefig = plots.Axes.savefig
    monkeypatch.setattr(plots.Axes, "savefig",
                        lambda self, path: (saved.append(self), real_savefig(self, path)))
    cm.plot(save_dir=str(tmp_path), names=("a", "b", "c"))
    png = imread(str(tmp_path / "confusion_matrix.png"))[..., ::-1]
    assert png.shape == (1500, 2250, 3)

    ref = matplotlib.colormaps["Blues"](np.arange(256))[:, :3]
    assert np.abs(plots.BLUES / 255.0 - ref).max() <= 1 / 255
    # and is matplotlib's byte table itself
    np.testing.assert_array_equal(
        plots.BLUES, matplotlib.colormaps["Blues"](np.arange(256), bytes=True)[:, :3])

    ax = saved[0]
    m = cm.matrix / (cm.matrix.sum(0, keepdims=True) + 1e-6)
    blank = 0
    for i in range(4):
        for j in range(4):
            r0, r1, c0, c1 = ax.cell_box(i, j)
            want = ((255, 255, 255) if m[i, j] < 0.005
                    else tuple(plots.BLUES[plots.blues_index(m[i, j])]))
            blank += m[i, j] < 0.005
            for r, c in ((r0 + 3, c0 + 3), (r0 + 3, c1 - 4), (r1 - 4, c0 + 3), (r1 - 4, c1 - 4)):
                assert tuple(png[r, c]) == want, (i, j)
    assert 0 < blank < 16
