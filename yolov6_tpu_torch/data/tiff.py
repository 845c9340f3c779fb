"""TIFF reading and writing without libtiff, cv2 or PIL: what ``cv2.imread``
and ``cv2.imwrite`` do with a ``.tif`` file (OpenCV 5's reader, which goes
through libtiff 4.7's RGBA interface), and what the JAX package's
``TrainValDataset.load_image`` returns where cv2 gives None (its PIL
branch).

``decode_tiff`` reads the first IFD of a classic (``II*\\0``/``MM\\0*``) or
BigTIFF (``II+\\0``/``MM\\0+``) file, its strips or tiles, planar
configuration 1 or 2, compressed with nothing, LZW (the horizontal
predictor at 8 and 16 bits), PackBits, Deflate (8 and 32946), CCITT Group 3
and Group 4 fax (``csrc/tiff_codec.cc``) or JPEG (7, through
``data/jpeg.py`` with the ``JPEGTables`` spliced ahead of each strip). The
samples convert as libtiff's ``TIFFReadRGBAStrip`` converts them:

- min-is-white and min-is-black at 1, 2, 4, 8 bits scale to 8 bits
  (``x * 255 / (2^bits - 1)``); at 16 bits the high byte is kept;
- a palette expands to its colours, a colormap of 16-bit entries shifted
  down 8 bits unless every entry is below 256 (libtiff's ``checkcmap``);
- RGB at 8 bits as stored, at 16 bits rounded (``(v + 128) / 257``);
  unassociated alpha premultiplies the colour (``(v * a + 127) / 255``),
  associated alpha passes as stored, and alpha is dropped at the end;
- CMYK (InkSet 1) at 8 bits: ``(255 - k) * (255 - c) / 255`` and so on;
- YCbCr under JPEG compression: libjpeg's YCbCr->RGB at its defaults.

Orientations 1-4 come out flipped as cv2 returns them; under 5-8 cv2
returns None, and the JAX package's PIL branch gives an 8-bit RGB image
oriented (``_pil_branch``; other modes raise). Floating-point and signed
samples, old-style JPEG (6), uncompressed YCbCr and any other compression, photometric or
sample layout raise ``ValueError`` naming the file and the kind: cv2 gives
None for them, and the JAX package's PIL branch raises or, for float
samples, gives a float image its loaders do not take.

A DNG is a TIFF (``DNGVersion``, tag 50706) and is read as one: its first
IFD, an RGB preview as a rule, the raw CFA data of a SubIFD unread; a DNG
whose first IFD is the CFA data raises, as it does in the JAX package.

``encode_tiff`` writes the bytes of ``cv2.imencode('.tif', img)``: LZW with
the horizontal predictor, ``8192 // row bytes`` rows a strip, one sample
plane, the tags in cv2's order and layout.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from yolov6_tpu_torch.data.jpeg import decode_jpeg_as, orient
from yolov6_tpu_torch.data.native_aug import build_library, library_path

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "tiff_codec.cc")
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
_ERRLEN = 256
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
               16: 8, 17: 8, 18: 8}
_TYPE_FORMATS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q",
                 18: "Q"}
COMPRESSIONS = {1: "none", 3: "Group 3 fax", 4: "Group 4 fax", 5: "LZW", 7: "JPEG",
                8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
# photometric interpretations PIL opens (the JAX package's check_image needs it)
_PIL_PHOTOMETRICS = (0, 1, 2, 3, 5, 6, 8)
DNG_VERSION = 50706

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The library built from ``csrc/tiff_codec.cc``, compiled if needed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path(SOURCE)
            if not os.path.exists(so):
                build_library(SOURCE, so)
            lib = ctypes.CDLL(so)
            size_p = ctypes.POINTER(ctypes.c_size_t)
            for name in ("yolov6_tiff_lzw_decode", "yolov6_tiff_lzw_encode",
                         "yolov6_tiff_packbits_decode"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                               size_p, ctypes.c_char_p, ctypes.c_int]
            lib.yolov6_tiff_fax_decode.restype = ctypes.c_int
            lib.yolov6_tiff_fax_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def _call(fn, path, src: bytes, want: int, kind: str) -> np.ndarray:
    out = np.zeros(want, np.uint8)
    got = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    if fn(src, len(src), out.ctypes.data, want, ctypes.byref(got), err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    if got.value < want:
        raise ValueError(f"{path}: {kind} TIFF strip decodes to {got.value} of {want} bytes")
    return out


class Ifd:
    """The tags of one TIFF image file directory: ``tag -> tuple`` of
    numbers, or ``bytes`` for ASCII and UNDEFINED values."""

    def __init__(self, tags: Dict[int, object], le: bool):
        self.tags = tags
        self.le = le

    def get(self, tag: int, default=None):
        v = self.tags.get(tag)
        return default if v is None else v

    def one(self, tag: int, default=None):
        v = self.tags.get(tag)
        return default if v is None else v[0]


def parse_ifd0(data: bytes, path: str = "<bytes>") -> Ifd:
    """The first IFD of the TIFF ``data`` (classic or BigTIFF, either byte
    order). Raises ``ValueError`` on a header or directory out of the file."""
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{path}: not a TIFF file")
    le = data[:2] == b"II"
    e = "<" if le else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    try:
        if big:
            first = struct.unpack_from(e + "Q", data, 8)[0]
            count = struct.unpack_from(e + "Q", data, first)[0]
            entry, at, inline = 20, first + 8, 8
        else:
            first = struct.unpack_from(e + "I", data, 4)[0]
            count = struct.unpack_from(e + "H", data, first)[0]
            entry, at, inline = 12, first + 2, 4
        tags = {}
        for k in range(count):
            o = at + k * entry
            if big:
                tag, typ, n = struct.unpack_from(e + "HHQ", data, o)
            else:
                tag, typ, n = struct.unpack_from(e + "HHI", data, o)
            size = _TYPE_SIZES.get(typ)
            if size is None:
                continue  # an unknown type: libtiff skips the entry
            nbytes = size * n
            vo = o + (12 if big else 8)
            if nbytes > inline:
                vo = struct.unpack_from(e + ("Q" if big else "I"), data, vo)[0]
            raw = data[vo:vo + nbytes]
            if len(raw) < nbytes:
                raise ValueError(f"{path}: TIFF tag {tag} points past the end of the file")
            if typ in (2, 7):
                tags[tag] = raw
            elif typ in (5, 10):
                vals = struct.unpack(e + ("I" if typ == 5 else "i") * (2 * n), raw)
                tags[tag] = tuple(vals[i] / vals[i + 1] if vals[i + 1] else 0.0
                                  for i in range(0, len(vals), 2))
            elif typ in (11, 12):
                tags[tag] = struct.unpack(e + ("f" if typ == 11 else "d") * n, raw)
            else:
                tags[tag] = struct.unpack(e + _TYPE_FORMATS[typ] * n, raw)
    except struct.error:
        raise ValueError(f"{path}: truncated TIFF directory") from None
    return Ifd(tags, le)


def _geometry(ifd: Ifd, path: str):
    w, h = ifd.one(256), ifd.one(257)
    if not w or not h:
        raise ValueError(f"{path}: TIFF without an image width and length")
    return int(w), int(h)


def _photometric(ifd: Ifd) -> Optional[int]:
    pm = ifd.one(262)
    if pm is None:  # libtiff's guess for a file without the tag
        spp = ifd.one(277, 1)
        pm = 1 if spp == 1 else (2 if spp == 3 else None)
    return pm


def tiff_size(data: bytes, path: str = "<bytes>") -> Tuple[int, int]:
    """``(w, h)`` of the first IFD, as the JAX package's ``check_image``
    records it through PIL: ``TiffImageFile`` has no ``_getexif``, but PIL
    opens a TIFF under orientation 5-8 at the swapped size. Raises where
    PIL does not open the file: a photometric interpretation it has no mode
    for (a DNG's CFA data, 32803)."""
    ifd = parse_ifd0(data, path)
    pm = _photometric(ifd)
    if pm not in _PIL_PHOTOMETRICS:
        raise ValueError(f"{path}: TIFF of photometric interpretation {pm}"
                         f"{' (a DNG CFA image)' if pm == 32803 else ''}: no pixel mode reads it")
    w, h = _geometry(ifd, path)
    return (h, w) if ifd.one(274, 1) >= 5 else (w, h)


def _segments(ifd: Ifd, data: bytes, path: str, w: int, h: int, spp_plane: int, planes: int):
    """Each strip or tile: ``(plane, x0, y0, width, rows, stored rows, raw bytes)``."""
    tiled = 322 in ifd.tags
    if tiled:
        tw, th = ifd.one(322), ifd.one(323)
        offsets, counts = ifd.get(324), ifd.get(325)
        across, down = -(-w // tw), -(-h // th)
        layout = [(p, tx * tw, ty * th, tw, th, th) for p in range(planes)
                  for ty in range(down) for tx in range(across)]
    else:
        rps = min(ifd.one(278, h), h) or h
        offsets, counts = ifd.get(273), ifd.get(279)
        n = -(-h // rps)
        layout = [(p, 0, s * rps, w, min(rps, h - s * rps), rps) for p in range(planes)
                  for s in range(n)]
    if offsets is None:
        raise ValueError(f"{path}: TIFF without strip or tile offsets")
    if counts is None or len(counts) < len(offsets):
        raise ValueError(f"{path}: TIFF without strip or tile byte counts")
    if len(offsets) < len(layout):
        raise ValueError(f"{path}: TIFF with {len(offsets)} strips or tiles of {len(layout)}")
    out = []
    for i, seg in enumerate(layout):
        raw = data[offsets[i]:offsets[i] + counts[i]]
        out.append(seg + (raw,))
    return tiled, out


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _decompress(comp, raw: bytes, want: int, seg_w: int, rows: int, ifd: Ifd, path: str):
    lib = load()
    if comp == 1:
        if len(raw) < want:
            raise ValueError(f"{path}: truncated TIFF strip ({len(raw)} of {want} bytes)")
        return np.frombuffer(raw, np.uint8, want)
    if comp == 5:
        return _call(lib.yolov6_tiff_lzw_decode, path, raw, want, "LZW")
    if comp == 32773:
        return _call(lib.yolov6_tiff_packbits_decode, path, raw, want, "PackBits")
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, want)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt TIFF Deflate data: {e}") from None
        if len(out) < want:
            raise ValueError(f"{path}: Deflate TIFF strip decodes to {len(out)} of {want} bytes")
        return np.frombuffer(out, np.uint8)
    if comp in (3, 4):
        out = np.zeros(seg_w * rows, np.uint8)
        err = ctypes.create_string_buffer(_ERRLEN)
        t4 = ifd.one(292, 0) if comp == 3 else 0
        if lib.yolov6_tiff_fax_decode(raw, len(raw), out.ctypes.data, seg_w, rows, comp, t4, err,
                                      _ERRLEN):
            raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
        return out
    raise AssertionError(comp)


def _samples(ifd: Ifd, data: bytes, path: str, w: int, h: int, bps: int, spp: int,
             comp: int) -> np.ndarray:
    """The stored samples, ``(h, w, spp)``: uint8, uint16 at 16 bits; a
    fax image gives its 0/1 bits as 1-bit samples."""
    planar = ifd.one(284, 1)
    planes = spp if planar == 2 and spp > 1 else 1
    spp_plane = spp // planes
    predictor = ifd.one(317, 1)
    if predictor not in (1, 2):
        raise ValueError(f"{path}: TIFF predictor {predictor} (floating point) is not read")
    if predictor == 2 and bps not in (8, 16):
        raise ValueError(f"{path}: TIFF horizontal predictor at {bps} bits is not read")
    if comp in (3, 4) and (bps != 1 or spp != 1):
        raise ValueError(f"{path}: fax-compressed TIFF of {spp} samples at {bps} bits")
    reverse = ifd.one(266, 1) == 2 and comp != 7
    tiled, segs = _segments(ifd, data, path, w, h, spp_plane, planes)
    dtype = np.dtype(("<" if ifd.le else ">") + "u2") if bps == 16 else np.dtype(np.uint8)
    out = np.zeros((planes, h, w, spp_plane), np.uint16 if bps == 16 else np.uint8)
    for plane, x0, y0, seg_w, rows, stored_rows, raw in segs:
        if reverse:
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        nrows = stored_rows if tiled else rows
        if comp in (3, 4):
            px = _decompress(comp, raw, 0, seg_w, nrows, ifd, path).reshape(nrows, seg_w, 1)
        else:
            rowbytes = (seg_w * spp_plane * bps + 7) // 8
            flat = _decompress(comp, raw, rowbytes * nrows, seg_w, nrows, ifd, path)
            rowsb = flat[:rowbytes * nrows].reshape(nrows, rowbytes)
            if bps == 16:
                px = rowsb.view(dtype).astype(np.uint16).reshape(nrows, seg_w, spp_plane)
            elif bps == 8:
                px = rowsb.reshape(nrows, seg_w, spp_plane)
            else:
                shifts = np.arange(8 - bps, -1, -bps, dtype=np.uint8)
                vals = (rowsb[:, :, None] >> shifts) & ((1 << bps) - 1)
                px = vals.reshape(nrows, -1)[:, :seg_w * spp_plane].reshape(nrows, seg_w,
                                                                           spp_plane)
            if predictor == 2:  # horizontal differencing, per sample, mod 2^bps
                px = np.cumsum(px, axis=1, dtype=px.dtype)
        cw, ch = min(seg_w, w - x0), min(nrows, h - y0)
        out[plane, y0:y0 + ch, x0:x0 + cw] = px[:ch, :cw]
    if planes > 1:
        return np.ascontiguousarray(np.concatenate(list(out), axis=2))
    return out[0]


def _jpeg_tiff(ifd: Ifd, data: bytes, path: str, w: int, h: int, pm: int) -> np.ndarray:
    """A JPEG-compressed TIFF (7) as RGB: each strip or tile a JPEG stream,
    the ``JPEGTables`` stream spliced ahead of it; YCbCr converted to RGB by
    libjpeg (libtiff's JPEGCOLORMODE_RGB), RGB and grey as stored."""
    if ifd.one(284, 1) != 1:
        raise ValueError(f"{path}: JPEG-compressed TIFF in separate planes is not read")
    if pm not in (1, 2, 6):
        raise ValueError(f"{path}: JPEG-compressed TIFF of photometric {pm} is not read")
    tables = ifd.get(347)
    head = bytes(tables[:-2]) if tables and len(tables) > 4 else b""
    mode = {6: "ycbcr", 2: "none", 1: "none"}[pm]
    tiled, segs = _segments(ifd, data, path, w, h, 3, 1)
    out = np.zeros((h, w, 3), np.uint8)
    for _, x0, y0, seg_w, rows, _, raw in segs:
        stream = head + bytes(raw[2:]) if head else bytes(raw)
        bgr = decode_jpeg_as(stream, path, mode)
        cw, ch = min(seg_w, w - x0, bgr.shape[1]), min(rows, h - y0, bgr.shape[0])
        out[y0:y0 + ch, x0:x0 + cw] = bgr[:ch, :cw, ::-1]
    return out


def _to_rgb(ifd: Ifd, px: np.ndarray, path: str, pm: int, bps: int, spp: int) -> np.ndarray:
    """libtiff's RGBA conversion of the samples, alpha dropped: HxWx3 RGB."""
    extras = ifd.get(338, ())
    if pm in (0, 1):
        g = px[:, :, 0]
        if bps == 16:
            g = (g >> 8).astype(np.uint8)
            return np.repeat((255 - g if pm == 0 else g)[:, :, None], 3, axis=2)
        rng = (1 << bps) - 1
        lut = np.array([((rng - x) if pm == 0 else x) * 255 // rng for x in range(rng + 1)],
                       np.uint8)
        return np.repeat(lut[g][:, :, None], 3, axis=2)
    if pm == 3:
        cmap = np.array(ifd.get(320, ()), np.int64)
        n = 1 << bps
        if cmap.size < 3 * n:
            raise ValueError(f"{path}: palette TIFF without a colormap of {n} entries")
        cmap = cmap[:3 * n].reshape(3, n)
        if (cmap >= 256).any():  # checkcmap: 16-bit entries
            cmap = cmap >> 8
        return np.ascontiguousarray(cmap.T.astype(np.uint8)[px[:, :, 0]])
    if pm == 2:
        if spp - len(extras) < 3 and spp < 3:
            raise ValueError(f"{path}: RGB TIFF with {spp} samples a pixel")
        if bps == 16:
            px = ((px.astype(np.uint32) + 128) // 257).astype(np.uint8)
        rgb = px[:, :, :3]
        alpha = None
        if spp >= 4:
            kind = extras[0] if extras else 1  # no ExtraSamples: libtiff takes associated
            if kind == 2:
                alpha = px[:, :, 3]
        if alpha is not None:  # UaToAa
            rgb = ((rgb.astype(np.uint32) * alpha[:, :, None] + 127) // 255).astype(np.uint8)
        return np.ascontiguousarray(rgb)
    if pm == 5:
        if ifd.one(332, 1) != 1 or spp < 4 or bps != 8:
            raise ValueError(f"{path}: separated TIFF other than 8-bit CMYK (InkSet 1, "
                             f"{spp} samples at {bps} bits) is not read")
        k = 255 - px[:, :, 3].astype(np.uint32)
        return np.stack([(k * (255 - px[:, :, i].astype(np.uint32)) // 255).astype(np.uint8)
                         for i in range(3)], axis=2)
    raise ValueError(f"{path}: TIFF of photometric interpretation {pm}"
                     f"{' (a DNG CFA image)' if pm == 32803 else ''} is not read")


def _pil_branch(px: np.ndarray, path: str, pm: int, bps: int, spp: int,
                orientation: int) -> np.ndarray:
    """What the JAX package's PIL branch gives for a TIFF under orientation
    5-8, where cv2 returns None: PIL (12) opens the file at the swapped size
    and, for an 8-bit RGB image, reads the pixels transposed as the
    orientation says, so that both ``cvtColor(np.asarray(im), RGB2BGR)``
    and ``im.convert("RGB")`` give the oriented image. For any other mode
    PIL's pixels do not match its size (they are not an image of the
    file), and the port raises."""
    if bps == 8 and pm == 2 and spp == 3:
        return orient(np.ascontiguousarray(px[:, :, 2::-1]), orientation)
    raise ValueError(f"{path}: TIFF with Exif orientation {orientation}, which cv2 does not read, "
                     f"of photometric {pm}, {spp} samples at {bps} bits, which PIL does not read "
                     "as an image of the file")


def decode_tiff(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The TIFF ``data`` as the JAX package's loaders read it:
    ``cv2.imread``'s HxWx3 uint8 BGR, or their PIL branch where cv2 gives
    None (see the module doc). Raises ``ValueError`` naming ``path`` and the
    kind for a file neither reads."""
    ifd = parse_ifd0(data, path)
    w, h = _geometry(ifd, path)
    bps_all = ifd.get(258, (1,))
    bps = bps_all[0]
    spp = ifd.one(277, 1)
    comp = ifd.one(259, 1)
    pm = _photometric(ifd)
    fmt = ifd.one(339, 1)
    orientation = ifd.one(274, 1)
    if fmt == 3:
        raise ValueError(f"{path}: TIFF of {bps}-bit floating-point samples: cv2 reads none and "
                         "PIL's mode does not convert")
    if fmt not in (1, 4) or bps not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: TIFF of {bps}-bit samples of sample format {fmt} is not read")
    if comp == 6:
        raise ValueError(f"{path}: old-style JPEG TIFF (compression 6) is not read")
    if comp not in COMPRESSIONS:
        raise ValueError(f"{path}: TIFF compression {comp} is not read; the port reads "
                         + ", ".join(sorted(set(COMPRESSIONS.values()))))
    if pm is None:
        raise ValueError(f"{path}: TIFF without a photometric interpretation")
    if comp == 7:
        rgb = _jpeg_tiff(ifd, data, path, w, h, pm)
        if orientation >= 5:
            return _pil_branch(rgb, path, 2, 8, 3 if pm != 1 else 1, orientation)
    else:
        if pm == 6:
            raise ValueError(f"{path}: YCbCr TIFF without JPEG compression is not read")
        if pm in (0, 1, 3) and ifd.one(284, 1) == 1 and spp != 1 and bps < 8:
            raise ValueError(f"{path}: TIFF of {spp} samples at {bps} bits is not read")
        px = _samples(ifd, data, path, w, h, bps, spp, comp)
        if orientation >= 5:
            return _pil_branch(px, path, pm, bps, spp, orientation)
        rgb = _to_rgb(ifd, px, path, pm, bps, spp)
    bgr = rgb[:, :, ::-1]
    if orientation in (2, 3):
        bgr = bgr[:, ::-1]
    if orientation in (3, 4):
        bgr = bgr[::-1]
    return np.ascontiguousarray(bgr)


def encode_tiff(img: np.ndarray) -> bytes:
    """``img`` (HW or HWx1 grey, HWx3 BGR or HWx4 BGRA, uint8) as the bytes
    of ``cv2.imencode('.tif', img)``: little-endian, LZW with the horizontal
    predictor, ``max(1, min(h, 8192 // (w * channels)))`` rows a strip."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_tiff needs uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        px = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        px = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)  # BGR(A) -> RGB(A)
    else:
        raise ValueError(f"encode_tiff needs HW, HWx3 or HWx4, got {img.shape}")
    h, w, c = px.shape
    rps = max(1, min(h, 8192 // (w * c)))
    diff = px.copy()
    diff[:, 1:] -= px[:, :-1]  # the horizontal predictor, mod 256
    lib = load()
    strips = []
    err = ctypes.create_string_buffer(_ERRLEN)
    for y0 in range(0, h, rps):
        raw = np.ascontiguousarray(diff[y0:y0 + rps]).tobytes()
        out = np.empty(len(raw) * 3 // 2 + 16, np.uint8)
        got = ctypes.c_size_t()
        if lib.yolov6_tiff_lzw_encode(raw, len(raw), out.ctypes.data, out.size,
                                      ctypes.byref(got), err, _ERRLEN):
            raise ValueError(f"encode_tiff: {err.value.decode(errors='replace')}")
        strips.append(out[:got.value].tobytes())
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    ifd_at = pos + (pos & 1)
    short = lambda v: 3 if v < 65536 else 4  # noqa: E731
    # libtiff writes the byte counts of several LZW strips as SHORT when a
    # strip's uncompressed size is below 65535 / 10 (its worst case for LZW)
    counts_type = 3 if len(strips) > 1 and rps * w * c < 0xFFFF // 10 else 4
    entries = [(256, short(w), [w]), (257, short(h), [h]), (258, 3, [8] * c), (259, 3, [5]),
               (262, 3, [1 if c == 1 else 2]), (273, 4, offsets), (277, 3, [c]),
               (278, short(rps), [rps]), (279, counts_type, [len(s) for s in strips]),
               (284, 3, [1]), (317, 3, [2]), (339, 3, [1] * c)]
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    blobs = {}
    # out-of-line values follow the directory in cv2's (libtiff's) order
    for tag in (258, 279, 273, 339):
        typ, vals = next((t, v) for g, t, v in entries if g == tag)
        size = _TYPE_SIZES[typ] * len(vals)
        if size > 4:
            blobs[tag] = extra_at
            extra_at += size
    d = bytearray(b"II*\x00" + struct.pack("<I", ifd_at))
    for s in strips:
        d += s
    d += b"\x00" * (ifd_at - len(d))
    d += struct.pack("<H", len(entries))
    tail = bytearray()
    for tag, typ, vals in entries:
        fmt = "<" + _TYPE_FORMATS[typ] * len(vals)
        if tag in blobs:
            d += struct.pack("<HHII", tag, typ, len(vals), blobs[tag])
        else:
            d += struct.pack("<HHI", tag, typ, len(vals)) + struct.pack(fmt, *vals).ljust(4, b"\0")
    d += struct.pack("<I", 0)
    for tag in (258, 279, 273, 339):
        if tag in blobs:
            typ, vals = next((t, v) for g, t, v in entries if g == tag)
            tail += struct.pack("<" + _TYPE_FORMATS[typ] * len(vals), *vals)
    return bytes(d + tail)
