"""YOLO-format dataset and the inference source (port of
yolov6_tpu/data/datasets.py:41-758).

``check_image``, the scan with its image and label checks, the label cache,
rect batching, the ratio-keeping pre-resize with ``shrink_size``, the
letterbox and the COCO ground-truth JSON, on numpy and the standard library:
images are PNG, JPEG or BMP, read by ``data/image_io.py``. A file the scan
cannot read is kept at shape (0, 0) and resolved at its first decode, or
dropped under ``check_images``, as in JAX.
``LoadData`` streams image and video files to the inferer (the frames of
a video through ``data/video.py``); a webcam raises ``NotImplementedError``.

With ``augment=True`` a sample takes the JAX package's native train path
(datasets.py:396-640), at ``img_size`` or, with ``specific_shape``, at
``height`` x ``width``: with probability ``mosaic``, four images in a mosaic
under a random affine (optionally mixed up with a second mosaic), else the
letterbox and a random affine; then the HSV jitter and the flips. The pixel
passes are ``data/native_aug.py``'s C++ library; every random value is drawn
from a ``Draws`` seeded by ``(seed, epoch, index)``, so a sample does not
depend on which loader thread made it. A JPEG is read as the JAX package's
native library reads it for that path (``native/dataload.cc``
``yolov6_decode_jpeg_resize``: ``data/jpeg.py::read_jpeg_train``); that
library's batch decode-and-letterbox is not ported.

The train path's image caches (JAX: datasets.py:143-182, 374-460) keep its
decoded, pre-resized RGB image: ``cache="ram"`` in the dataset's memory, at
first use; ``cache="disk"`` as one ``.npy`` an image in
``.torch_img_cache_v2_{dir}_{size}`` beside the images (``size`` is
``img_size``, or ``max(height, width)`` at a specific shape), written through a
temporary name and ``os.replace`` so that ranks sharing the directory never
read a torn file. A cached sample is the uncached one bit for bit: the
draws, the mosaic and the HSV pass read the same bytes. Neither tier checks
an image that changed after it was cached.

The label cache, the COCO GT file and the disk tier have names of their own
(``.{dir}.torch_cache.json``, ``.{dir}_torch_coco_gt.json``), so that the
JAX package and the port can run on one set; the first two are written
through a temporary name too.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import os.path as osp
import threading
from multiprocessing.pool import ThreadPool
from pathlib import Path
from typing import List, Optional

import numpy as np

from yolov6_tpu_torch.data import native_aug
from yolov6_tpu_torch.data.data_augment import (
    Draws,
    augment_hsv_rgb,
    letterbox,
    mixup,
    resize_area,
    resize_linear,
    sample_seed,
)
from yolov6_tpu_torch.data.image_io import image_format, image_size, imread
from yolov6_tpu_torch.data.video import VideoCapture
from yolov6_tpu_torch.data.jpeg import (
    decode_jpeg_cmyk, encode_jpeg, jpeg_info, orient, read_jpeg_train, train_denom,
)

LOGGER = logging.getLogger(__name__)

IMG_FORMATS = ["bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo"]
VID_FORMATS = ["mp4", "mov", "avi", "mkv"]
# 3: the entry records the scan's checks, so that an unchecked scan is not
# read back as a checked one
CACHE_VERSION = 3
# in the disk tier's directory name; 2: JPEGs read as the JAX package's native
# train path reads them (DCT-scaled decode, its bilinear resize)
IMG_CACHE_VERSION = 2


def restore_jpeg(im_file: str, img: np.ndarray) -> None:
    """Rewrite the JPEG ``im_file`` whose decode (orientation applied) is
    ``img`` as JAX's ``check_image`` has PIL rewrite it: the Exif
    orientation applied and dropped, quality 100, 4:4:4, grey kept grey,
    CMYK kept CMYK (libjpeg's samples, which PIL inverts on the way in and
    back on the way out)."""
    with open(im_file, "rb") as f:
        src = f.read()
    _, _, orientation, components = jpeg_info(src, im_file)
    if components == 4:
        img = orient(decode_jpeg_cmyk(src, im_file), orientation)
    elif components == 1:
        img = img[:, :, 0]
    data = encode_jpeg(img, quality=100, subsampling="444")
    tmp = f"{im_file}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, im_file)


def check_image(im_file: str, full_check: bool = False):
    """``(shape (w, h) or None, message)`` of one image (JAX:
    datasets.py:41-91, with the port's readers in place of PIL): the header
    shape, w and h swapped under Exif orientation 6 or 8. With
    ``full_check`` a PNG, JPEG, MPO or BMP also decodes whole (a TIFF or
    WebP is left to the loader: PIL's ``verify`` reads none of their
    pixels), each side must exceed 9 pixels, the format must be in
    ``IMG_FORMATS``, and a JPEG that does not end in EOI is restored in
    place (``restore_jpeg``) with a warning message. On any failure a plain decode decides, as JAX's cv2 fallback
    does: its shape when it decodes (so a small image is kept, as in JAX),
    else None with the reason."""
    msg = ""
    try:
        shape = image_size(im_file)
        if full_check:
            fmt = image_format(im_file)
            # PIL's verify reads no TIFF or WebP pixels: those are left to the loader
            img = imread(im_file) if fmt not in ("tiff", "webp") else None
            assert shape[0] > 9 and shape[1] > 9, f"image size {shape} <10 pixels"
            assert fmt in IMG_FORMATS, f"invalid image format {fmt}"
            if fmt == "jpeg":
                with open(im_file, "rb") as f:
                    f.seek(-2, 2)
                    if f.read() != b"\xff\xd9":  # corrupt JPEG: missing EOI
                        restore_jpeg(im_file, img)
                        msg = f"WARNING: {im_file}: corrupt JPEG restored and saved"
        return shape, msg
    except Exception as e:
        try:
            im = imread(im_file)
            return (im.shape[1], im.shape[0]), msg
        except Exception:
            pass
        return None, f"WARNING: {im_file}: ignoring corrupt image: {e}"


def img2label_paths(img_paths: List[str]) -> List[str]:
    """images/xxx.png -> labels/xxx.txt (reference convention)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for p in img_paths]


def get_hash(paths: List[str]) -> str:
    return hashlib.md5("".join(sorted(paths)).encode()).hexdigest()


class TrainValDataset:
    """YOLO-format dataset. ``__getitem__`` returns ``(img RGB HWC uint8,
    labels [n, 5] (cls, cx, cy, w, h normalised), path, shapes)``, where
    ``shapes`` is ``((h0, w0), ((ry, rx), (pad_w, pad_h)))``, or None for a
    mosaic sample. With ``augment``, sample ``index`` of epoch ``epoch``
    draws from ``Draws(sample_seed(seed, epoch, index))``."""

    def __init__(
        self,
        img_dir: str,
        img_size: int = 640,
        batch_size: int = 16,
        augment: bool = False,
        hyp: Optional[dict] = None,
        rect: bool = False,
        stride: int = 32,
        pad: float = 0.0,
        data_dict: Optional[dict] = None,
        task: str = "train",
        specific_shape: bool = False,
        height: Optional[int] = None,
        width: Optional[int] = None,
        seed: int = 0,
        cache: Optional[str] = None,
        check_images: bool = False,
        check_labels: bool = False,
    ):
        if augment and (rect or (hyp or {}).get("shrink_size")):
            raise ValueError("augment=True takes no rect batches or shrink_size (the JAX "
                             "trainer passes neither to its train loader)")
        if specific_shape and not (height and width):
            raise ValueError("specific_shape needs height and width")
        if cache not in (None, "ram", "disk"):
            raise ValueError(f"cache={cache!r}: None, 'ram' or 'disk'")
        if cache and not augment:
            raise ValueError("the image caches keep the train path's images (augment=True)")
        self.img_dir = img_dir
        self.img_size = img_size
        self.batch_size = batch_size
        self.augment = augment
        self.hyp = hyp or {}
        self.rect = rect
        self.stride = stride
        self.pad = pad
        self.data_dict = data_dict or {}
        self.task = task
        self.specific_shape = specific_shape
        self.target_height = height
        self.target_width = width
        self.seed = seed
        self.epoch = 0

        self.img_paths, self.labels, self.shapes = self._load_annotations(
            img_dir, check_images, check_labels)
        self.n = len(self.img_paths)
        self.cache = cache
        self._ram = [None] * self.n if cache == "ram" else None
        if cache == "disk":
            size = max(height, width) if specific_shape else img_size
            self.disk_cache_dir = osp.join(
                osp.dirname(osp.dirname(self.img_paths[0])) or ".",
                f".torch_img_cache_v{IMG_CACHE_VERSION}_{osp.basename(str(img_dir))}_{size}")
            os.makedirs(self.disk_cache_dir, exist_ok=True)
        if self.rect:
            self._setup_rect_batches()
        else:
            self.batch_shapes = None
            self.batch_indices = None

        if self.task.lower() == "val" and self.data_dict.get("is_coco") is False:
            # non-COCO datasets get an auto-generated COCO-format GT json
            self.data_dict["anno_path"] = self.generate_coco_format_labels()

    # ------------------------------------------------------------------ scan

    def _scan_images(self, img_dir: str) -> List[str]:
        p = Path(img_dir)
        if p.is_file():
            with open(p) as f:
                entries = [line.strip() for line in f if line.strip()]
            img_paths = [e if osp.isabs(e) else str(p.parent / e) for e in entries]
        else:
            img_paths = sorted(
                x for x in glob.glob(str(p / "**" / "*"), recursive=True)
                if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS
            )
        if not img_paths:
            raise FileNotFoundError(f"no images found in {img_dir}")
        return img_paths

    def _load_annotations(self, img_dir, check_images=False, check_labels=False):
        """The scan (JAX: datasets.py:210-269): each image's header shape and
        label rows, through the label cache. An image ``check_image`` cannot
        read is dropped under ``check_images`` and otherwise kept at (0, 0);
        under ``check_labels`` a label file with a value out of range (any
        below 0, a coordinate above 1) gives its image no labels, as a file
        that does not parse does."""
        img_paths = self._scan_images(img_dir)
        label_paths = img2label_paths(img_paths)
        cache_path = osp.join(osp.dirname(osp.dirname(img_paths[0])) or ".",
                              f".{osp.basename(img_dir)}.torch_cache.json")
        cache_key = get_hash(img_paths + label_paths)
        checks = [bool(check_images), bool(check_labels)]
        cached = None
        if osp.exists(cache_path):
            try:
                with open(cache_path) as f:
                    data = json.load(f)
                if (data.get("hash") == cache_key and data.get("version") == CACHE_VERSION
                        and data.get("checks") == checks):
                    cached = data["labels"]
            except (OSError, ValueError, KeyError) as e:
                LOGGER.warning(f"ignoring the label cache {cache_path}: {e}")

        if cached is None:
            def parse(args):
                """-> (img_path, label rows, shape (w, h)), or None to drop
                the image; the shape comes from the header, so rect batching
                and the GT JSON decode nothing."""
                img_path, lb_path = args
                shape, msg = check_image(img_path, full_check=check_images)
                if msg:
                    LOGGER.warning(msg)
                if shape is None:
                    if check_images:
                        return None
                    shape = (0, 0)  # resolved at its first decode
                if not osp.exists(lb_path):
                    return img_path, [], shape
                try:
                    rows = []
                    with open(lb_path) as f:
                        for line in f:
                            vals = line.split()
                            if len(vals) == 5:
                                rows.append([float(v) for v in vals])
                    if check_labels and rows:
                        arr = np.array(rows)
                        assert (arr >= 0).all() and (arr[:, 1:] <= 1).all(), "label out of range"
                    return img_path, rows, shape
                except (OSError, ValueError, AssertionError) as e:
                    LOGGER.warning(f"skipping {lb_path}: {e}")
                    return img_path, [], shape

            with ThreadPool(8) as pool:
                results = [r for r in pool.map(parse, zip(img_paths, label_paths)) if r]
            cached = {p: {"labels": rows, "shape": list(shape)} for p, rows, shape in results}
            try:
                _write_json({"hash": cache_key, "version": CACHE_VERSION, "checks": checks,
                             "labels": cached}, cache_path)
            except OSError as e:
                LOGGER.warning(f"could not write the label cache {cache_path}: {e}")

        paths = [p for p in img_paths if p in cached]
        labels = [np.array(cached[p]["labels"], np.float32).reshape(-1, 5) for p in paths]
        shapes = np.array([cached[p]["shape"] for p in paths], np.float64)  # (w, h)
        return paths, labels, shapes

    def _resolve_shapes(self) -> np.ndarray:
        """Cached (w, h) per image; an unknown (0, 0) entry is read now."""
        shapes = np.asarray(self.shapes, np.float64)
        for i in np.flatnonzero((shapes <= 0).any(axis=1)):
            shapes[i] = self._resolve_shape(int(i))
        self.shapes = shapes
        return shapes

    # ------------------------------------------------------------ rect mode

    def _setup_rect_batches(self):
        """Aspect-ratio bucketing for rect eval (reference: datasets.py:497-522),
        from the shapes in the scan cache."""
        shapes = self._resolve_shapes()
        ar = shapes[:, 1] / shapes[:, 0]  # h / w
        order = np.argsort(ar)
        self.img_paths = [self.img_paths[i] for i in order]
        self.labels = [self.labels[i] for i in order]
        self.shapes = shapes[order]
        ar = ar[order]

        n_batches = int(np.ceil(self.n / self.batch_size))
        self.batch_indices = np.floor(np.arange(self.n) / self.batch_size).astype(int)
        batch_shapes = []
        for b in range(n_batches):
            ari = ar[self.batch_indices == b]
            mini, maxi = ari.min(), ari.max()
            shape = [1, 1]
            if maxi < 1:
                shape = [maxi, 1]
            elif mini > 1:
                shape = [1, 1 / mini]
            batch_shapes.append(
                np.ceil(np.array(shape) * self.img_size / self.stride + self.pad).astype(int)
                * self.stride
            )
        self.batch_shapes = batch_shapes

    # ------------------------------------------------------------- get item

    def __len__(self):
        return self.n

    def load_image(self, index, shrink_size: Optional[int] = None):
        """Decode and pre-resize keeping the aspect ratio (reference:
        datasets.py:257-295): INTER_AREA when shrinking, INTER_LINEAR when
        enlarging. Returns ``(BGR image, (h0, w0), (h, w))``."""
        im = imread(self.img_paths[index])
        h0, w0 = im.shape[:2]
        if self.specific_shape:
            ratio = min(self.target_width / w0, self.target_height / h0)
        elif shrink_size:
            ratio = (self.img_size - shrink_size) / max(h0, w0)
        else:
            ratio = self.img_size / max(h0, w0)
        if ratio != 1:
            resize = resize_area if ratio < 1 else resize_linear
            im = resize(im, (int(w0 * ratio), int(h0 * ratio)))
        return im, (h0, w0), im.shape[:2]

    def _disk_file(self, index) -> str:
        path = self.img_paths[index]
        stem = osp.splitext(osp.basename(path))[0]
        return osp.join(self.disk_cache_dir,
                        f"{stem}.{hashlib.md5(path.encode()).hexdigest()[:10]}.rgb.npy")

    def load_image_rgb(self, index):
        """The train path's decode and pre-resize (JAX: datasets.py:396-459
        ``_load_image_rgb``) to ``img_size / max(h0, w0)``, or at a specific
        shape ``min(width / w0, height / h0)``, ``(h0, w0)`` from the scan,
        served from the cache tier when there is one. A ``.jpg``/``.jpeg``
        file is read as the JAX package's native library reads it
        (``jpeg.read_jpeg_train``: libjpeg's DCT-scaled decode at the largest
        1/2, 1/4 or 1/8 that keeps the long side at the target or above, then
        its float bilinear resize; the Exif orientation applied first, as
        cv2 applies it); any other file, and a JPEG libjpeg does not convert
        to RGB (CMYK, YCCK), is ``imread`` and INTER_LINEAR, as JAX's fallback.
        Returns ``(RGB image, (h0, w0), (h, w))``; the image is shared with
        the cache and is not to be written."""
        if self._ram is not None and self._ram[index] is not None:
            return self._ram[index]
        cache_file = self._disk_file(index) if self.cache == "disk" else None
        if cache_file is not None and osp.exists(cache_file):
            try:
                im = np.load(cache_file)
                w0, h0 = self._resolve_shape(index)
                return im, (h0, w0), im.shape[:2]
            except (OSError, ValueError) as e:
                LOGGER.warning(f"re-decoding {self.img_paths[index]}: cache file {e}")
        path = self.img_paths[index]
        w0, h0 = self._resolve_shape(index)
        if self.specific_shape:
            ratio = min(self.target_width / w0, self.target_height / h0)
            target = max(self.target_height, self.target_width)
        else:
            ratio = self.img_size / max(h0, w0)
            target = self.img_size
        dst_h, dst_w = int(h0 * ratio), int(w0 * ratio)
        im = None
        if path.lower().endswith((".jpg", ".jpeg")):
            im = read_jpeg_train(path, train_denom(h0, w0, target), dst_h, dst_w)
        if im is None:
            im = np.ascontiguousarray(imread(path)[:, :, ::-1])
            if im.shape[:2] != (dst_h, dst_w):
                im = resize_linear(im, (dst_w, dst_h))
        out = im, (h0, w0), im.shape[:2]
        if self._ram is not None:
            self._ram[index] = out
        elif cache_file is not None:
            tmp = f"{cache_file}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
            try:
                np.save(tmp, im)
                os.replace(tmp, cache_file)
            except OSError as e:
                LOGGER.warning(f"could not write the image cache {cache_file}: {e}")
        return out

    def _resolve_shape(self, index):
        """The cached (w, h) of one image, read now if unknown (JAX:
        datasets.py:384-394); an image that does not read raises
        ``FileNotFoundError``."""
        w0, h0 = self.shapes[index]
        if w0 <= 0 or h0 <= 0:
            shape, _ = check_image(self.img_paths[index])
            if shape is None:
                raise FileNotFoundError(f"unreadable image {self.img_paths[index]}")
            w0, h0 = shape
        return int(w0), int(h0)

    def _one_mosaic(self, index, target_hw, rng: Draws, flip_lr, flip_ud):
        """One mosaic of ``index`` and three drawn images (JAX:
        datasets.py:461-481). Returns ``(RGB image, labels xyxy)``."""
        indices = [index] + rng.py.choices(range(self.n), k=3)
        rng.py.shuffle(indices)
        imgs = [self.load_image_rgb(i)[0] for i in indices]
        return native_aug.mosaic_affine(imgs, [self.labels[i] for i in indices], self.hyp, rng,
                                        target_hw[0], target_hw[1], flip_lr, flip_ud)

    def _mosaic_sample(self, index, target_hw, rng: Draws):
        """The mosaic branch (JAX: datasets.py:483-517): flips drawn first and
        applied in the warp, the optional mixup with a second mosaic, then
        the HSV jitter. Returns ``(image, labels xyxy, flip_lr, flip_ud)``."""
        flip_lr, flip_ud = native_aug.draw_flips(self.hyp, rng)
        img, labels = self._one_mosaic(index, target_hw, rng, flip_lr, flip_ud)
        if rng.py.random() < self.hyp.get("mixup", 0.0):
            img2, labels2 = self._one_mosaic(rng.py.randint(0, self.n - 1), target_hw, rng,
                                             flip_lr, flip_ud)
            img, labels = mixup(img, labels, img2, labels2, rng)
        augment_hsv_rgb(img, native_aug.draw_hsv_gains(self.hyp, rng))
        return img, labels, flip_lr, flip_ud

    def __getitem__(self, index):
        target_shape = (
            (self.target_height, self.target_width) if self.specific_shape
            else self.batch_shapes[self.batch_indices[index]] if self.rect
            else self.img_size
        )
        target_hw = ((target_shape, target_shape) if isinstance(target_shape, int)
                     else tuple(int(v) for v in target_shape))
        rng = Draws(sample_seed(self.seed, self.epoch, index)) if self.augment else None
        flips = None  # the train path's pixel flips, applied to the labels below

        if self.augment and rng.py.random() < self.hyp.get("mosaic", 0.0):
            img, labels, *flips = self._mosaic_sample(index, target_hw, rng)
            shapes = None
        else:
            if self.augment:
                img, (h0, w0), (h, w) = self.load_image_rgb(index)
                img, ratio, pad = native_aug.letterbox(img, target_hw, scaleup=True)
            else:
                shrink = self.hyp.get("shrink_size") if self.hyp else None
                img, (h0, w0), (h, w) = self.load_image(index, shrink)
                img, ratio, pad = letterbox(img, target_shape, auto=False, scaleup=False)
            shapes = (h0, w0), ((h * ratio / h0, w * ratio / w0), pad)

            labels = self.labels[index].copy()
            if labels.size:
                w_r, h_r = w * ratio, h * ratio
                boxes = np.copy(labels[:, 1:])
                boxes[:, 0] = w_r * (labels[:, 1] - labels[:, 3] / 2) + pad[0]
                boxes[:, 1] = h_r * (labels[:, 2] - labels[:, 4] / 2) + pad[1]
                boxes[:, 2] = w_r * (labels[:, 1] + labels[:, 3] / 2) + pad[0]
                boxes[:, 3] = h_r * (labels[:, 2] + labels[:, 4] / 2) + pad[1]
                labels[:, 1:] = boxes

            if self.augment:
                flips = native_aug.draw_flips(self.hyp, rng)
                img, labels = native_aug.affine(
                    img, labels, degrees=self.hyp.get("degrees", 0.0),
                    translate=self.hyp.get("translate", 0.1), scale=self.hyp.get("scale", 0.5),
                    shear=self.hyp.get("shear", 0.0), new_shape=target_hw, rng=rng,
                    flip_lr=flips[0], flip_ud=flips[1])
                augment_hsv_rgb(img, native_aug.draw_hsv_gains(self.hyp, rng))

        if len(labels):
            h, w = img.shape[:2]
            labels[:, [1, 3]] = labels[:, [1, 3]].clip(0, w - 1e-3)
            labels[:, [2, 4]] = labels[:, [2, 4]].clip(0, h - 1e-3)
            boxes = np.copy(labels[:, 1:])
            boxes[:, 0] = ((labels[:, 1] + labels[:, 3]) / 2) / w
            boxes[:, 1] = ((labels[:, 2] + labels[:, 4]) / 2) / h
            boxes[:, 2] = (labels[:, 3] - labels[:, 1]) / w
            boxes[:, 3] = (labels[:, 4] - labels[:, 2]) / h
            labels[:, 1:] = boxes

        if flips is None:
            img = np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB, keep HWC
        elif len(labels):
            # the pixels were flipped in the warp; the labels follow in the
            # JAX order, flipud then fliplr
            flip_lr, flip_ud = flips
            if flip_ud:
                labels[:, 2] = 1 - labels[:, 2]
            if flip_lr:
                labels[:, 1] = 1 - labels[:, 1]
        return img, labels.astype(np.float32), self.img_paths[index], shapes

    # --------------------------------------------------------- COCO GT json

    def generate_coco_format_labels(self) -> str:
        """Write a COCO-format GT json for a non-COCO dataset (reference:
        datasets.py:599-652); annotation ids start at 1, since COCOeval takes
        id 0 for "unmatched"."""
        class_names = self.data_dict.get("names", [])
        out = {"info": {"description": "auto-generated by yolov6_tpu"}, "images": [],
               "annotations": [], "categories": []}
        for i, name in enumerate(class_names):
            out["categories"].append({"id": i, "name": str(name), "supercategory": str(name)})
        ann_id = 1
        save_path = osp.join(
            osp.dirname(osp.dirname(self.img_paths[0])) or ".",
            f".{osp.basename(str(self.img_dir))}_torch_coco_gt.json",
        )
        shapes = self._resolve_shapes()
        for idx, (path, labels) in enumerate(zip(self.img_paths, self.labels)):
            w, h = (int(shapes[idx][0]), int(shapes[idx][1]))
            img_id = osp.splitext(osp.basename(path))[0]
            img_id = int(img_id) if img_id.isnumeric() else img_id
            out["images"].append(
                {"id": img_id, "file_name": osp.basename(path), "width": w, "height": h}
            )
            for cls, xc, yc, bw, bh in labels.tolist():
                x1 = (xc - bw / 2) * w
                y1 = (yc - bh / 2) * h
                out["annotations"].append(
                    {
                        "id": ann_id, "image_id": img_id, "category_id": int(cls),
                        "bbox": [x1, y1, bw * w, bh * h], "area": bw * w * bh * h,
                        "iscrowd": 0, "segmentation": [],
                    }
                )
                ann_id += 1
        _write_json(out, save_path)
        LOGGER.info(f"COCO-format GT labels saved to {save_path}")
        return save_path


def _write_json(obj, path: str) -> None:
    """``json.dump`` through a temporary name: a reader (another rank) sees
    the old file or the new one, never a torn one."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class LoadData:
    """The inferer's source (JAX: datasets.py:691-758): the image and video
    files under ``path`` (a recursive, sorted glob filtered by
    ``IMG_FORMATS`` and ``VID_FORMATS``; images first, then videos) or the
    one file ``path``, yielding ``(img BGR HWC uint8, path, cap)``. ``type``
    turns ``"video"`` at the first video, whose frames come from the port's
    ``data/video.py::VideoCapture`` (opened per file; ``cap`` is it), one a
    call, the next file at a file's end; ``nf`` counts files.
    ``webcam=True`` raises ``NotImplementedError``: the port reads no
    camera."""

    def __init__(self, path: str, webcam: bool = False, webcam_addr: str = "0"):
        if webcam:
            raise NotImplementedError(
                f"webcam source {webcam_addr!r}: the port reads video files, not cameras")
        p = str(Path(path).resolve())
        if os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "**", "*.*"), recursive=True))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"Invalid path {p}")
        imgp = [f for f in files if f.split(".")[-1].lower() in IMG_FORMATS]
        vidp = [f for f in files if f.split(".")[-1].lower() in VID_FORMATS]
        self.files = imgp + vidp
        self.nf = len(self.files)
        self.type = "image"
        self.cap = None

    @staticmethod
    def checkext(path):
        return "video" if path.split(".")[-1].lower() in VID_FORMATS else "image"

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]
        if self.checkext(path) == "video":
            self.type = "video"
            if self.cap is None or not self.cap.isOpened():
                self.cap = VideoCapture(path)
            ret_val, img = self.cap.read()
            while not ret_val:
                self.count += 1
                self.cap.release()
                if self.count == self.nf:
                    raise StopIteration
                path = self.files[self.count]
                self.cap = VideoCapture(path)
                ret_val, img = self.cap.read()
        else:
            self.count += 1
            img = imread(path)
        return img, path, self.cap

    def __len__(self):
        return self.nf
