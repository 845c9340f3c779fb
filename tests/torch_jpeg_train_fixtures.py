"""Writes the small JPEG set of ``tests/data/torch_jpeg_train/`` with cv2 and
PIL, and ``manifest.json`` beside it: for each file its scan shape, the
SHA-256 of ``cv2.imread``'s pixels, and for each of two train-path reads
(``img_size`` 64, and the specific shape 96 x 160) the DCT scale's
denominator, the pre-resized size and the SHA-256 of the RGB image the
port's ``TrainValDataset.load_image_rgb`` must give, with where that hash
comes from:

- ``jax``: the JAX package's ``TrainValDataset._load_image_rgb`` with its
  native library (``native.decode_jpeg_resize_native``: libjpeg-turbo's
  DCT-scaled decode and its float bilinear), or its cv2 fallback for the
  CMYK file and the PNG named ``.jpg``;
- ``cv2_reduced_oriented``: for the Exif-6 file, where the port departs
  from JAX on purpose, ``cv2.imread`` at ``IMREAD_REDUCED_COLOR_<denom>``
  (oriented) resized by ``bilinear`` below, a numpy twin of the native
  library's bilinear. Its ``jax_sha256`` is JAX's stretched, unrotated read.

The sizes select the denominators 1, 2, 4 and 8 at 64; the set holds
4:2:0 (odd chroma width), 4:2:2, 4:4:4, 4:4:0 and 4:1:1, grey, progressive,
restart intervals, odd sizes, a CMYK file, two progressive files cut before
their last scans (where libjpeg-turbo block-smooths; 4:2:2 and 4:4:4, whose
vertical sampling of 1 leaves the system's 2.1.5 and cv2's 3.1.2 nothing to
differ on, see ``tests/test_torch_train_jpeg.py``), an
Exif-6 file and a PNG named ``.jpg``. ``chip_smoke.py`` [39] holds the
port's reads, built by the card machine's compiler, to these hashes;
``tests/test_torch_train_jpeg.py`` holds the files to JAX and cv2 here. Run
from the repository root to rewrite them:

    python tests/torch_jpeg_train_fixtures.py
"""

import hashlib
import io
import json
import os
import shutil
import struct
import sys
import tempfile

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "data", "torch_jpeg_train")
IMG_SIZE = 64
SPECIFIC = (96, 160)  # (height, width)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
REDUCED = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}
EXIF6 = "d2_exif6_200x150.jpg"


def picture(h, w, seed):
    """Blurred noise with a little detail: JPEG keeps both smooth areas and
    edges, and the files stay small."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.addWeighted(cv2.GaussianBlur(noise, (0, 0), 4), 0.9, noise, 0.1, 0)


def cv2_jpeg(h, w, seed, sampling="420", quality=85, progressive=False, rst=0, grey=False):
    img = picture(h, w, seed)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if grey:
        img = img[:, :, 1]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def pil_jpeg(h, w, seed, mode="RGB", **kw):
    out = io.BytesIO()
    Image.fromarray(picture(h, w, seed)[:, :, ::-1]).convert(mode).save(out, "JPEG", **kw)
    return out.getvalue()


def bilinear(src, dh, dw):
    """The JAX native library's BilinearResize (native/dataload.cc) in numpy
    float32: half-pixel centres, each operation rounded to float32 as the
    library (built without contraction) rounds it, std::lround at the end."""
    h, w = src.shape[:2]
    f32 = np.float32
    sx, sy = f32(w) / f32(dw), f32(h) / f32(dh)

    def axis(n, s, size):
        f = (np.arange(n, dtype=f32) + f32(0.5)) * s - f32(0.5)
        i0 = np.floor(f).astype(np.int64)
        wgt = (f - i0.astype(f32)).astype(f32)
        return np.maximum(i0, 0), np.minimum(i0 + 1, size - 1), wgt

    y0, y1, wy = axis(dh, sy, h)
    x0, x1, wx = axis(dw, sx, w)
    src = src.astype(f32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    v00, v01 = src[y0][:, x0], src[y0][:, x1]
    v10, v11 = src[y1][:, x0], src[y1][:, x1]
    v0 = v00 + (v01 - v00) * wx
    v1 = v10 + (v11 - v10) * wx
    v = (v0 + (v1 - v0) * wy).astype(f32)
    return np.floor(v.astype(np.float64) + 0.5).astype(np.uint8)  # lround; v >= 0


def exif_app1(orientation):
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def agreeing_cut(data, path):
    """The first cut of the progressive ``data`` from 35% of its bytes on
    that ends before the progression's last scan (so that its first AC
    coefficients are not final, and libjpeg block-smooths it), and at which
    the system libjpeg-turbo (the JAX native library) and cv2's decode the
    same full-size image."""
    from yolov6_tpu import native

    for frac in np.arange(0.35, 0.8, 0.025):
        cut = data[:int(len(data) * frac)]
        if cut.count(b"\xff\xda") >= data.count(b"\xff\xda"):
            break
        with open(path, "wb") as f:
            f.write(cut)
        want = cv2.imread(path)
        if want is None:
            continue
        got = native.decode_jpeg_resize_native(path, 1, *want.shape[:2])
        if got is not None and np.array_equal(got, want[:, :, ::-1]):
            return cut
    raise RuntimeError("no cut on which the two libjpeg-turbo releases agree")


def files(scratch):
    """name -> bytes of the set."""
    out = {
        "d1_420_100x75.jpg": cv2_jpeg(75, 100, 1),
        "d2_422_201x131.jpg": cv2_jpeg(131, 201, 2, "422"),
        "d4_444_301x203.jpg": cv2_jpeg(203, 301, 3, "444"),
        "d8_440_521x389.jpg": cv2_jpeg(389, 521, 4, "440", quality=75),
        "d8_420_1001x667.jpg": cv2_jpeg(667, 1001, 5, "420", quality=50),
        "d2_411_255x130.jpg": cv2_jpeg(130, 255, 6, "411"),
        "d2_grey_190x150.jpg": cv2_jpeg(150, 190, 7, grey=True),
        "d2_prog_420_250x171.jpg": cv2_jpeg(171, 250, 8, progressive=True),
        "d4_rst_420_333x250.jpg": cv2_jpeg(250, 333, 9, rst=3),
        "d2_prog_rst_422_181x140.jpg": cv2_jpeg(140, 181, 10, "422", progressive=True, rst=2),
        "d2_cmyk_200x140.jpg": pil_jpeg(140, 200, 11, "CMYK"),
        "d2_png_named.jpg": cv2.imencode(".png", picture(90, 130, 12))[1].tobytes(),
    }
    tmp = os.path.join(scratch, "cut.jpg")
    out["d2_cut_prog_422_241x181.jpg"] = agreeing_cut(
        cv2_jpeg(181, 241, 13, "422", progressive=True), tmp)
    out["d4_cut_prog_444_300x263.jpg"] = agreeing_cut(
        pil_jpeg(263, 300, 14, progressive=True, subsampling="4:4:4", quality=90), tmp)
    base = cv2_jpeg(150, 200, 15)
    out[EXIF6] = base[:2] + exif_app1(6) + base[2:]
    return out


def sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def jax_reads(root, **kw):
    """name -> (image, (h0, w0)) of the JAX train path's read."""
    import conftest  # noqa: F401  (JAX on the CPU)
    from yolov6_tpu.data.datasets import TrainValDataset

    ds = TrainValDataset(root, img_size=IMG_SIZE, batch_size=1, augment=True,
                         hyp=dict(mosaic=1.0), task="train", **kw)
    assert ds._native_aug
    return {os.path.basename(p): ds._load_image_rgb(i)[:2] for i, p in enumerate(ds.img_paths)}


def main():
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO_ROOT)
    with tempfile.TemporaryDirectory() as scratch:
        data = files(scratch)
        root = os.path.join(scratch, "images")
        os.makedirs(root)
        for name, blob in data.items():
            with open(os.path.join(root, name), "wb") as f:
                f.write(blob)
        reads = {IMG_SIZE: jax_reads(root),
                 SPECIFIC: jax_reads(root, specific_shape=True, height=SPECIFIC[0],
                                     width=SPECIFIC[1])}
        manifest = {"img_size": IMG_SIZE, "specific_shape": list(SPECIFIC), "files": {}}
        for name in sorted(data):
            path = os.path.join(root, name)
            entry = {"imread_sha256": sha(cv2.imread(path)), "reads": []}
            for target, by_name in reads.items():
                img, (h0, w0) = by_name[name]
                entry["shape"] = [w0, h0]
                long_target = max(target) if isinstance(target, tuple) else target
                denom = 1
                for n in (2, 4, 8):
                    if max(h0, w0) / n >= long_target:
                        denom = n
                read = {"target": list(target) if isinstance(target, tuple) else target,
                        "denom": denom, "dst": list(img.shape[:2]), "sha256": sha(img),
                        "from": "jax", "jax_sha256": sha(img)}
                if name == EXIF6:
                    oriented = cv2.imread(path, REDUCED[denom])[:, :, ::-1]
                    mine = bilinear(oriented, *img.shape[:2])
                    read.update(sha256=sha(mine), **{"from": "cv2_reduced_oriented"})
                entry["reads"].append(read)
            manifest["files"][name] = entry
        if os.path.isdir(FIXTURES):
            shutil.rmtree(FIXTURES)
        os.makedirs(FIXTURES)
        for name, blob in data.items():
            with open(os.path.join(FIXTURES, name), "wb") as f:
                f.write(blob)
        with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
