"""TensorBoard event files without the ``tensorboard`` package (the machine
with the card has neither it nor ``tensorboardX``): the counterpart of the
``torch.utils.tensorboard.SummaryWriter`` calls the JAX trainer makes
(yolov6_tpu/core/engine.py:270-277, yolov6_tpu/utils/events.py:74-92).

``TBWriter(log_dir)`` writes ``events.out.tfevents.<10-digit time>.<host>.
<pid>.<n>`` in ``log_dir``, as torch names it, so that ``tensorboard
--logdir`` finds it. Each record is a little-endian u64 length, the masked
CRC-32C of those 8 bytes, the payload, and the masked CRC-32C of the payload
(mask: ``((c >> 15) | (c << 17)) + 0xa282ead8`` mod 2**32). The payloads are
``Event`` protos, encoded here by hand: the first holds ``file_version =
"brain.Event:2"``; the others ``wall_time`` (1, double), ``step`` (2,
int64) and ``summary`` (5), whose ``value`` (1) is ``{tag (1),
simple_value (2, float)}`` for a scalar and ``{tag (1), image (4) =
{height (1), width (2), colorspace (3), encoded_image_string (4) = PNG}}``
for an image.

``read_events(path)`` reads such a file back, both CRCs checked, as a list
of dicts. CRC-32C is not in ``zlib``: ``crc32c`` runs the byte table over
many slices of the data at once in numpy and joins the slices' CRCs, since
a byte loop in Python costs about a second a megabyte and a train-batch
mosaic's PNG is about 10 MB. ``TBWriter.write_s`` sums the time spent
encoding and writing.
"""

from __future__ import annotations

import os
import os.path as osp
import socket
import struct
import time
from itertools import count
from typing import List

import numpy as np

from yolov6_tpu_torch.data.image_io import encode_png

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_MASK_DELTA = 0xA282EAD8
_CHUNK = 1024  # bytes a slice in the numpy path
_uid = count()


def _byte_table() -> np.ndarray:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(_POLY), c >> 1)
    return c


_TABLE = _byte_table()
_TABLE_LIST = [int(v) for v in _TABLE]
_SHIFT = None  # [4, 256]: the register after _CHUNK zero bytes, by byte of the start


def _shift_tables() -> np.ndarray:
    """``T[k][v]``: the raw register after ``_CHUNK`` zero bytes from ``v << 8k``
    (the map is linear, so a register's shift is the XOR of its four bytes')."""
    global _SHIFT
    if _SHIFT is None:
        s = (np.arange(256, dtype=np.uint32)[None] << (8 * np.arange(4, dtype=np.uint32))[:, None])
        for _ in range(_CHUNK):
            s = _TABLE[s & 0xFF] ^ (s >> 8)
        _SHIFT = s
    return _SHIFT


def _crc_loop(data: bytes, crc: int = 0) -> int:
    """The raw register (no init, no final XOR) after ``data`` from ``crc``."""
    t = _TABLE_LIST
    for b in data:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` (init and final XOR 0xFFFFFFFF)."""
    if len(data) < 4 * _CHUNK:
        return _crc_loop(data, 0xFFFFFFFF) ^ 0xFFFFFFFF
    # the init folds into the first 4 bytes; leading zeros leave a zero
    # register as it is, so the data is zero-padded in front to whole slices
    buf = np.frombuffer(data, np.uint8).copy()
    buf[:4] ^= 0xFF
    pad = (-len(buf)) % _CHUNK
    slices = np.concatenate([np.zeros(pad, np.uint8), buf]).reshape(-1, _CHUNK).T.copy()
    reg = np.zeros(slices.shape[1], np.uint32)
    for col in slices:
        reg = _TABLE[(reg ^ col) & 0xFF] ^ (reg >> 8)
    shift = [[int(v) for v in row] for row in _shift_tables()]
    s0, s1, s2, s3 = shift
    crc = 0
    for r in reg.tolist():
        crc = s0[crc & 0xFF] ^ s1[(crc >> 8) & 0xFF] ^ s2[(crc >> 16) & 0xFF] ^ s3[crc >> 24] ^ r
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ------------------------------------------------------------------ protobuf

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # int64 two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _varint(field << 3) + _varint(int(v))


def _event(wall_time: float, step: int = None, summary: bytes = None,
           file_version: str = None) -> bytes:
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _int_field(2, step)
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary is not None:
        out += _len_field(5, summary)
    return out


def _read_varint(buf: bytes, pos: int):
    shift = value = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """``(field, wire type, value)`` of each field of a proto message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"proto wire type {wire} not read here")
        yield field, wire, value


# --------------------------------------------------------------- the writer

class TBWriter:
    """``add_scalar``, ``add_image``, ``flush`` and ``close`` of
    ``SummaryWriter`` into one event file in ``log_dir`` (made if missing;
    a directory that cannot be written raises ``OSError``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s.%s.%s" % (time.time(), socket.gethostname(),
                                                        os.getpid(), next(_uid))
        self.path = osp.join(log_dir, name)
        self.write_s = 0.0
        self._f = open(self.path, "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _write(self, payload: bytes) -> None:
        head = struct.pack("<Q", len(payload))
        self._f.write(head + struct.pack("<I", masked_crc32c(head)) + payload
                      + struct.pack("<I", masked_crc32c(payload)))

    def _summary(self, value: bytes, step: int, walltime=None) -> None:
        self._write(_event(time.time() if walltime is None else walltime, int(step),
                           _len_field(1, value)))

    def add_scalar(self, tag: str, value, global_step: int = 0, walltime=None) -> None:
        t0 = time.perf_counter()
        self._summary(_len_field(1, tag.encode()) + _varint(2 << 3 | 5)
                      + struct.pack("<f", float(value)), global_step, walltime)
        self.write_s += time.perf_counter() - t0

    def add_image(self, tag: str, img, global_step: int = 0, walltime=None,
                  dataformats: str = "HWC") -> None:
        """``img``: HWC uint8 RGB (the only layout the trainer logs)."""
        t0 = time.perf_counter()
        img = np.asarray(img)
        if dataformats != "HWC" or img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise ValueError(f"add_image takes HWC uint8 RGB, got {img.shape} {img.dtype} "
                             f"as {dataformats}")
        h, w = img.shape[:2]
        png = encode_png(img[:, :, ::-1])  # encode_png takes cv2's BGR
        image = (_int_field(1, h) + _int_field(2, w) + _int_field(3, 3) + _len_field(4, png))
        self._summary(_len_field(1, tag.encode()) + _len_field(4, image), global_step, walltime)
        self.write_s += time.perf_counter() - t0

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_events(path: str) -> List[dict]:
    """The events of an event file, each ``{"wall_time", "step"}`` plus
    ``"file_version"``, or ``"scalars"`` (tag -> float) and ``"images"``
    (tag -> ``{"height", "width", "colorspace", "png"}``). Raises
    ``ValueError`` on a CRC that does not match or a truncated record."""
    with open(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        head = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        (head_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if head_crc != masked_crc32c(head):
            raise ValueError(f"{path}: length CRC mismatch at byte {pos}")
        payload = data[pos + 12:pos + 12 + n]
        if len(payload) != n or pos + 16 + n > len(data):
            raise ValueError(f"{path}: truncated record at byte {pos}")
        (crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(payload):
            raise ValueError(f"{path}: payload CRC mismatch at byte {pos}")
        events.append(_parse_event(payload))
        pos += 16 + n
    return events


def _parse_event(buf: bytes) -> dict:
    ev = {"wall_time": 0.0, "step": 0}
    for field, _, value in _fields(buf):
        if field == 1:
            ev["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2:
            ev["step"] = value - (1 << 64) if value >> 63 else value
        elif field == 3:
            ev["file_version"] = value.decode()
        elif field == 5:
            scalars, images = ev.setdefault("scalars", {}), ev.setdefault("images", {})
            for f, _, v in _fields(value):
                if f != 1:
                    continue
                tag, scalar, image = None, None, None
                for vf, _, vv in _fields(v):
                    if vf == 1:
                        tag = vv.decode()
                    elif vf == 2:
                        scalar = struct.unpack("<f", vv)[0]
                    elif vf == 4:
                        image = {"height": 0, "width": 0, "colorspace": 0}
                        for imf, _, imv in _fields(vv):
                            key = {1: "height", 2: "width", 3: "colorspace"}.get(imf)
                            if key:
                                image[key] = imv
                            elif imf == 4:
                                image["png"] = bytes(imv)
                if scalar is not None:
                    scalars[tag] = scalar
                if image is not None:
                    images[tag] = image
    return ev
