"""libavcodec's MPEG-4 Part 2 encoder, reached with ctypes in the test
process: the FFmpeg build that opencv-python bundles (the one cv2's
VideoWriter and VideoCapture run), with the encoder options cv2 cannot pass
(``flags=+mv4``, ``mpeg_quant``, ``ps`` for resync markers, adaptive
quantisation, ``qpel``, ``bf``, interlacing, ``data_partitioning``). The
streams are muxed by the port's ``Mp4Writer``, so that cv2 (the oracle) and
the port read the same file.

The struct offsets below are FFmpeg 8's (libavutil 60, libavcodec 62):
AVFrame's ``width``, ``height``, ``format`` and ``pts``, AVPacket's ``data``
and ``size``. ``encode`` checks the libraries' major versions first.
"""

import ctypes
import glob
import os

import cv2

from yolov6_tpu_torch.data import video
from yolov6_tpu_torch.data.video_container import Mp4Writer

LIBS = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
FRAME_WIDTH, FRAME_HEIGHT, FRAME_FORMAT, FRAME_PTS = 104, 108, 116, 136
PACKET_DATA, PACKET_SIZE = 24, 32
_P = ctypes.c_void_p


def _libs():
    avutil = ctypes.CDLL(glob.glob(os.path.join(LIBS, "libavutil-*.so*"))[0],
                         mode=ctypes.RTLD_GLOBAL)
    avcodec = ctypes.CDLL(glob.glob(os.path.join(LIBS, "libavcodec-*.so*"))[0],
                          mode=ctypes.RTLD_GLOBAL)
    assert avutil.avutil_version() >> 16 == 60 and avcodec.avcodec_version() >> 16 == 62, \
        "the struct offsets here are FFmpeg 8's"
    avcodec.avcodec_find_encoder_by_name.restype = _P
    avcodec.avcodec_find_encoder_by_name.argtypes = [ctypes.c_char_p]
    avcodec.avcodec_alloc_context3.restype = _P
    avcodec.avcodec_alloc_context3.argtypes = [_P]
    avcodec.avcodec_open2.argtypes = [_P, _P, _P]
    avcodec.avcodec_send_frame.argtypes = [_P, _P]
    avcodec.avcodec_receive_packet.argtypes = [_P, _P]
    avcodec.av_packet_alloc.restype = _P
    avcodec.av_packet_unref.argtypes = [_P]
    avcodec.av_packet_free.argtypes = [ctypes.POINTER(_P)]
    avcodec.avcodec_free_context.argtypes = [ctypes.POINTER(_P)]
    avutil.av_opt_set.argtypes = [_P, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    avutil.av_frame_alloc.restype = _P
    avutil.av_frame_get_buffer.argtypes = [_P, ctypes.c_int]
    avutil.av_frame_make_writable.argtypes = [_P]
    avutil.av_frame_free.argtypes = [ctypes.POINTER(_P)]
    return avutil, avcodec


def encode(frames, options, path, fps=25):
    """BGR ``frames`` through libavcodec's ``mpeg4`` encoder under
    ``options`` (name, value pairs of its AVOptions), muxed into the MP4 at
    ``path``. Returns the packets."""
    avutil, avcodec = _libs()
    h, w = frames[0].shape[:2]
    codec = avcodec.avcodec_find_encoder_by_name(b"mpeg4")
    ctx = _P(avcodec.avcodec_alloc_context3(codec))
    for key, value in [("video_size", f"{w}x{h}"), ("pixel_format", "yuv420p"),
                       ("time_base", f"1/{fps}"), *options]:
        assert avutil.av_opt_set(ctx, key.encode(), value.encode(), 1) == 0, (key, value)
    assert avcodec.avcodec_open2(ctx, codec, None) == 0, options
    frame, packet = _P(avutil.av_frame_alloc()), _P(avcodec.av_packet_alloc())
    out = []

    def drain():
        while avcodec.avcodec_receive_packet(ctx, packet) == 0:
            data = ctypes.c_void_p.from_address(packet.value + PACKET_DATA).value
            size = ctypes.c_int.from_address(packet.value + PACKET_SIZE).value
            out.append(ctypes.string_at(data, size))
            avcodec.av_packet_unref(packet)

    try:
        ctypes.c_int.from_address(frame.value + FRAME_WIDTH).value = w
        ctypes.c_int.from_address(frame.value + FRAME_HEIGHT).value = h
        ctypes.c_int.from_address(frame.value + FRAME_FORMAT).value = 0  # yuv420p
        assert avutil.av_frame_get_buffer(frame, 0) == 0
        for i, img in enumerate(frames):
            assert avutil.av_frame_make_writable(frame) == 0
            ctypes.c_int64.from_address(frame.value + FRAME_PTS).value = i
            for p, plane in enumerate(video.bgr_to_yuv420(img)):
                ptr = ctypes.c_void_p.from_address(frame.value + 8 * p).value
                stride = ctypes.c_int.from_address(frame.value + 64 + 4 * p).value
                for r in range(plane.shape[0]):
                    ctypes.memmove(ptr + r * stride, plane[r].ctypes.data, plane.shape[1])
            assert avcodec.avcodec_send_frame(ctx, frame) == 0
            drain()
        avcodec.avcodec_send_frame(ctx, None)
        drain()
    finally:
        avutil.av_frame_free(ctypes.byref(frame))
        avcodec.av_packet_free(ctypes.byref(packet))
        avcodec.avcodec_free_context(ctypes.byref(ctx))
    config = out[0][:out[0].find(b"\x00\x00\x01\xb6")]  # the in-band VOS/VOL
    writer = Mp4Writer(path, w, h, fps, config)
    for p in out:
        writer.write(p)
    writer.close()
    return out
