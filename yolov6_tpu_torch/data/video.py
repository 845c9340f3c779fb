"""Video files for the inferer: the port's counterparts of the
``cv2.VideoCapture`` and ``cv2.VideoWriter`` that the JAX package's
``LoadData`` and ``Inferer`` use (the machine with the card has no cv2).

``VideoCapture(path)`` reads MPEG-4 Part 2 (``mp4v``) and Motion JPEG from
MP4, MOV, AVI and MKV files (``data/video_container.py``) and returns BGR
uint8 frames as OpenCV's FFmpeg backend does:

- mp4v frames are decoded by ``data/mpeg4.py``, whose luma is FFmpeg's bit
  for bit, and turned from YUV 4:2:0 (BT.601, limited range) into BGR as
  swscale's unscaled converter does for OpenCV: each chroma sample covers
  its 2x2 luma samples;
- Motion JPEG frames are decoded by ``data/jpeg.py`` as FFmpeg's MJPEG
  decoder reconstructs them (libavcodec's simple IDCT, not libjpeg's: such
  frames differ from ``imread``'s) and converted from full range ("yuvj")
  the same way.

The colour conversion is swscale's x86 fixed point, so that the BGR frames
equal OpenCV's wherever the planes do (``tests/test_torch_video.py``).
Other codecs raise ``ValueError`` naming them (H.264, HEVC, VP9, AV1, ...).

``VideoWriter(path, fps, (w, h))`` writes an ``.mp4`` with an MPEG-4 Part 2
track: BGR to YUV 4:2:0 (BT.601, limited range, 2x2 chroma means), every
frame an I-VOP at a fixed quantiser (``data/mpeg4.py``), muxed by
``video_container.Mp4Writer``. ``cv2.VideoCapture`` reads it back.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from yolov6_tpu_torch.data import jpeg, mpeg4
from yolov6_tpu_torch.data.video_container import (
    Mp4Writer, VideoTrack, fps_timebase, open_container,
)

# OpenCV's property ids, so that code written against cv2 reads the same
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5
CAP_PROP_FRAME_COUNT = 7

# the writer's quantiser: at 2 each frame's PSNR is above cv2's mp4v writer's
# at its default rate on the test clips (tests/test_torch_video.py)
WRITER_QUANT = 2


def _r16(f: int) -> int:
    return (f + (1 << 15)) >> 16


def _yuv2rgb_coeffs(full_range: bool) -> Tuple[int, int, int, int, int, int]:
    """(y, v->r, u->g, v->g, u->b, y offset): swscale's ITU-R 601 ``inv_table``
    (104597, 132201, 25675, 53279) scaled as ``ff_yuv2rgb_c_init_tables``
    scales it for its x86 converter, in 13-bit fixed point."""
    crv, cbu, cgu, cgv = 104597, 132201, -25675, -53279
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu = crv * 224 // 255, cbu * 224 // 255
        cgu, cgv = -(25675 * 224 // 255), -(53279 * 224 // 255)
    else:
        cy, oy = cy * 255 // 219, 16 << 16
    return (_r16(cy << 13), _r16(crv << 13), _r16(cgu << 13), _r16(cgv << 13),
            _r16(cbu << 13), _r16(oy << 3))


_COEFFS = {full: _yuv2rgb_coeffs(full) for full in (False, True)}


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray, full_range: bool) -> np.ndarray:
    """BGR uint8 (h, w, 3) of BT.601 planes as OpenCV's FFmpeg backend gets
    them from swscale's unscaled x86 YUV-to-RGB converter: chroma (subsampled
    by 1 or 2 in each direction) taken nearest, samples scaled by 8 and
    multiplied high (``pmulhw``: the product's top 16 bits), summed, then
    saturated (``csrc/mpeg4_video.cc``). ``full_range``: JPEG's levels
    ("yuvj") instead of 16-235."""
    h, w = y.shape
    planes = [np.ascontiguousarray(p, dtype=np.uint8) for p in (y, u, v)]
    ch, cw = planes[1].shape
    sy = 1 if ch == h else 2
    sx = 1 if cw == w else 2
    if planes[2].shape != (ch, cw) or (h + sy - 1) // sy != ch or (w + sx - 1) // sx != cw:
        raise ValueError(f"chroma planes {u.shape}, {v.shape} for a {w}x{h} picture")
    k = (ctypes.c_int * 6)(*_COEFFS[full_range])
    out = np.empty((h, w, 3), np.uint8)
    mpeg4.load().yolov6_yuv_to_bgr(planes[0].ctypes.data, planes[1].ctypes.data,
                                   planes[2].ctypes.data, w, h, cw, sx, sy, k, out.ctypes.data)
    return out


def bgr_to_yuv420(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BT.601 limited-range Y, and Cb/Cr from each 2x2 block's mean colour
    (edge samples repeated for an odd size), rounded."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    cw, ch = mpeg4.chroma_size(w, h)
    y = np.empty((h, w), np.uint8)
    u = np.empty((ch, cw), np.uint8)
    v = np.empty((ch, cw), np.uint8)
    mpeg4.load().yolov6_bgr_to_yuv420(img.ctypes.data, w, h, y.ctypes.data, u.ctypes.data,
                                      v.ctypes.data)
    return y, u, v


class VideoCapture:
    """The frames of a video file, in order (``cv2.VideoCapture(path)``'s
    interface: ``isOpened``, ``read``, ``get``, ``release``). A missing file
    raises ``FileNotFoundError``; a container or codec the port does not read
    raises ``ValueError`` naming it."""

    def __init__(self, path: str):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"video file {path} not found")
        self.path = path
        self.track: Optional[VideoTrack] = open_container(path)
        self._next = 0
        self._decoder = (mpeg4.Mpeg4Decoder(self.track.config, path)
                         if self.track.codec == "mpeg4" else None)
        self._last: Optional[np.ndarray] = None

    def isOpened(self) -> bool:  # noqa: N802 (cv2's name)
        return self.track is not None

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """(True, the next frame as BGR uint8 (h, w, 3)), or (False, None)
        at the end. A sample without a coded picture repeats the last one."""
        if self.track is None or self._next >= len(self.track):
            return False, None
        i = self._next
        self._next += 1
        data = self.track.sample(i)
        if self.track.codec == "mjpeg":
            planes = jpeg.decode_jpeg_planes(data, f"{self.path} frame {i}")
            if len(planes) == 1:
                frame = np.repeat(planes[0][..., None], 3, -1)
            else:
                frame = yuv_to_bgr(*planes, full_range=True)
        else:
            pic = self._decoder.decode(data)
            if pic is None:
                if self._last is None:
                    return self.read()
                return True, self._last.copy()
            frame = yuv_to_bgr(*pic, full_range=False)
        self._last = frame
        return True, frame.copy()

    def get(self, prop: int) -> float:
        if self.track is None:
            return 0.0
        return float({CAP_PROP_FRAME_WIDTH: self.track.width,
                      CAP_PROP_FRAME_HEIGHT: self.track.height,
                      CAP_PROP_FPS: self.track.fps,
                      CAP_PROP_FRAME_COUNT: self.track.frame_count}.get(prop, 0.0))

    def release(self) -> None:
        if self.track is not None:
            self.track.close()
            self.track = None
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None


class VideoWriter:
    """An ``.mp4`` of MPEG-4 Part 2 I-VOPs (``cv2.VideoWriter(path,
    fourcc("mp4v"), fps, (w, h))``'s interface: ``isOpened``, ``write``,
    ``release``). A frame of another size raises ``ValueError`` (cv2 drops it
    silently)."""

    def __init__(self, path: str, fps: float, size: Tuple[int, int]):
        self.width, self.height = int(size[0]), int(size[1])
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"video size {size} is not positive")
        self._res, self._delta = fps_timebase(fps)
        self._mux = None  # for release() from __del__ if the muxer fails
        self._mux = Mp4Writer(path, self.width, self.height, fps,
                              mpeg4.encode_headers(self.width, self.height, self._res))
        self._n = 0

    def isOpened(self) -> bool:  # noqa: N802 (cv2's name)
        return self._mux is not None

    def write(self, frame: np.ndarray) -> None:
        if self._mux is None:
            raise ValueError("write to a released VideoWriter")
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"frame of shape {frame.shape} {frame.dtype} for a "
                             f"{self.width}x{self.height} BGR uint8 video")
        y, u, v = bgr_to_yuv420(frame)
        t, t0 = self._n * self._delta, (self._n - 1) * self._delta
        secs = t // self._res - (t0 // self._res if self._n else 0)
        sample = mpeg4.encode_vop(y, u, v, WRITER_QUANT, self._res, t % self._res, secs)
        if self._n == 0:  # the first sample also carries the headers, as in AVI
            sample = self._mux.config + sample
        self._mux.write(sample)
        self._n += 1

    def release(self) -> None:
        if self._mux is not None:
            self._mux.close()
            self._mux = None

    def __del__(self):
        self.release()
