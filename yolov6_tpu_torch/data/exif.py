"""The Exif orientation of a PNG ``eXIf`` chunk or a WebP ``EXIF`` chunk,
as OpenCV's ``ExifReader`` reads it for ``cv2.imread`` and PIL's
``_getexif`` for the JAX package's ``check_image``: the first Orientation
entry (tag 274) of IFD0, 1 when there is none or anything is off."""

from __future__ import annotations

import struct


def exif_orientation(payload: bytes) -> int:
    """Orientation 1-8 from Exif bytes (a TIFF header, after an optional
    ``Exif\\0\\0``)."""
    if payload.startswith(b"Exif\x00\x00"):
        payload = payload[6:]
    if len(payload) < 8 or payload[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if payload[:2] == b"II" else ">"
    if struct.unpack_from(e + "H", payload, 2)[0] != 42:
        return 1
    off = struct.unpack_from(e + "I", payload, 4)[0]
    if off + 2 > len(payload):
        return 1
    count = struct.unpack_from(e + "H", payload, off)[0]
    for k in range(count):
        o = off + 2 + 12 * k
        if o + 12 > len(payload):
            return 1
        tag, typ = struct.unpack_from(e + "HH", payload, o)
        if tag == 274:
            value = struct.unpack_from(e + ("H" if typ == 3 else "I"), payload, o + 8)[0]
            return value if 1 <= value <= 8 else 1
    return 1
