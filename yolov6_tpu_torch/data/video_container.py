"""Video containers on the host: the demuxers of ISO BMFF (``.mp4``,
``.mov``), AVI (RIFF, with OpenDML) and Matroska (``.mkv``), and an MP4
muxer, in numpy and ``struct``.

``open_container(path)`` finds the first video track and returns a
``VideoTrack``: its codec (``"mpeg4"`` for MPEG-4 Part 2, ``"mjpeg"`` for
Motion JPEG), size, decoder configuration (the VOL headers of an ``esds``,
of a Matroska ``CodecPrivate`` or of an AVI ``strf``), and its samples in
decode order, each read from the file as the bytes FFmpeg's demuxer hands
its decoder. ``fps`` and ``frame_count`` are what OpenCV's FFmpeg backend
reports through ``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``: FFmpeg's
``avg_frame_rate`` (MP4: samples over the ``stts`` duration; AVI: ``dwRate /
dwScale``; Matroska: ``DefaultDuration``) and ``nb_frames`` (MP4: the
samples; AVI: ``dwLength``), or ``round(duration * fps)`` where the container
has no count (Matroska: the segment's ``Duration``).

Any other codec raises ``ValueError`` naming it: H.264 (``avc1``,
``V_MPEG4/ISO/AVC``), HEVC, VP9, AV1 and the rest.

``Mp4Writer`` writes ``ftyp``, ``mdat`` and ``moov`` with one ``mp4v`` track
(an ``esds`` carrying the VOL headers, the frame rate as the ``stts``
timescale), as FFmpeg's MP4 muxer lays out the file that the JAX inferer's
``cv2.VideoWriter(..., "mp4v", fps, (w, h))`` writes.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import struct
from dataclasses import dataclass, field
from fractions import Fraction
from typing import BinaryIO, List, Optional, Tuple

# codecs the port decodes, by container tag
MP4_MPEG4 = {b"mp4v"}
MP4_MJPEG = {b"jpeg", b"mjpa"}
AVI_MPEG4 = {b"FMP4", b"DIVX", b"DX50", b"XVID", b"MP4V", b"MP4S", b"M4S2"}
AVI_MJPEG = {b"MJPG", b"AVRN", b"DMB1", b"JPGL"}
MKV_MPEG4 = {"V_MPEG4/ISO/ASP", "V_MPEG4/ISO/SP"}
MKV_MJPEG = {"V_MJPEG"}
# names for the refusals
KNOWN = {
    "avc1": "H.264", "avc3": "H.264", "h264": "H.264", "H264": "H.264", "X264": "H.264",
    "hvc1": "HEVC", "hev1": "HEVC", "HEVC": "HEVC", "vp08": "VP8", "VP80": "VP8",
    "vp09": "VP9", "VP90": "VP9", "av01": "AV1", "AV01": "AV1", "s263": "H.263",
    "H263": "H.263", "DIV3": "MS MPEG-4 v3", "MP42": "MS MPEG-4 v2", "mp4a": "AAC audio",
    "V_MPEG4/ISO/AVC": "H.264", "V_MPEGH/ISO/HEVC": "HEVC", "V_VP8": "VP8", "V_VP9": "VP9",
    "V_AV1": "AV1", "V_MPEG2": "MPEG-2", "V_MPEG1": "MPEG-1", "V_THEORA": "Theora",
    "V_MS/VFW/FOURCC": "a VFW codec",
}
SUPPORTED = "the port reads MPEG-4 Part 2 (mp4v) and Motion JPEG video"


def _refuse(path: str, tag: str) -> ValueError:
    name = KNOWN.get(tag)
    what = f"'{tag}' ({name})" if name else f"'{tag}'"
    return ValueError(f"{path}: video codec {what} is not supported; {SUPPORTED}")


def _tag(b: bytes) -> str:
    return b.decode("latin-1").rstrip("\0 ")


@dataclass
class VideoTrack:
    path: str
    codec: str  # "mpeg4" or "mjpeg"
    width: int
    height: int
    fps: float
    frame_count: int
    config: bytes = b""
    samples: List[Tuple[int, int]] = field(default_factory=list)  # (offset, size)
    keyframes: Optional[List[int]] = None  # MP4's stss (0-based); None: every sample
    _f: Optional[BinaryIO] = None

    def __len__(self) -> int:
        return len(self.samples)

    def sample(self, i: int) -> bytes:
        if self._f is None:
            self._f = open(self.path, "rb")
        off, size = self.samples[i]
        self._f.seek(off)
        data = self._f.read(size)
        if len(data) != size:
            raise ValueError(f"{self.path}: sample {i} runs past the end of the file")
        return data

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def open_container(path: str) -> VideoTrack:
    """The first video track of the file at ``path``, by its content:
    ISO BMFF, AVI or Matroska. Raises ``ValueError`` for another container,
    a file without a video track, or a codec the port does not decode."""
    with open(path, "rb") as f:
        head = f.read(12)
    if len(head) >= 8 and head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip"):
        return _mp4(path)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return _avi(path)
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return _mkv(path)
    raise ValueError(f"{path}: not an MP4/MOV, AVI or Matroska file")


# ---------------------------------------------------------------- ISO BMFF

_MP4_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}


def _boxes(data, off: int, end: int):
    while off + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, off)
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, off + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr or off + size > end:
            raise ValueError(f"box '{_tag(typ)}' of size {size} at {off} runs past its parent")
        yield typ, off + hdr, off + size
        off += size


def _descriptor(data: bytes, off: int) -> Tuple[int, int, int]:
    """(tag, payload offset, payload end) of an MPEG-4 descriptor."""
    tag = data[off]
    off += 1
    size = 0
    for _ in range(4):
        b = data[off]
        off += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, off, off + size


def _esds_config(esds: bytes, path: str) -> bytes:
    """The DecoderSpecificInfo of an ``esds`` (after its version and flags)."""
    tag, off, end = _descriptor(esds, 4)
    if tag != 3:
        raise ValueError(f"{path}: esds without an ES_Descriptor")
    flags = esds[off + 2]
    off += 3
    if flags & 0x80:
        off += 2
    if flags & 0x40:
        off += 1 + esds[off]
    if flags & 0x20:
        off += 2
    while off < end:
        tag, p, e = _descriptor(esds, off)
        if tag == 4:  # DecoderConfigDescriptor
            oti = esds[p]
            if oti != 0x20:
                raise ValueError(f"{path}: mp4v track with objectTypeIndication 0x{oti:02X}, not "
                                 f"MPEG-4 Visual (0x20); {SUPPORTED}")
            q = p + 13
            while q < e:
                t2, p2, e2 = _descriptor(esds, q)
                if t2 == 5:
                    return bytes(esds[p2:e2])
                q = e2
            return b""
        off = e
    return b""


@contextlib.contextmanager
def _mapped(path: str):
    """The file's bytes, mapped rather than read: a container's index is
    small beside its samples."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
        yield data


def _mp4(path: str) -> VideoTrack:
    with _mapped(path) as data:
        moov = next(((s, e) for t, s, e in _boxes(data, 0, len(data)) if t == b"moov"), None)
        if moov is None:
            raise ValueError(f"{path}: no moov box")
        for typ, s, e in _boxes(data, *moov):
            if typ != b"trak":
                continue
            track = _mp4_trak(path, data, s, e)
            if track is not None:
                return track
    raise ValueError(f"{path}: no video track")


def _mp4_trak(path: str, data, s: int, e: int) -> Optional[VideoTrack]:
    found = {}

    def walk(a, b):
        for typ, p, q in _boxes(data, a, b):
            if typ in _MP4_CONTAINERS:
                walk(p, q)
            else:
                found.setdefault(typ, (p, q))

    walk(s, e)
    hdlr = found.get(b"hdlr")
    if hdlr is None or bytes(data[hdlr[0] + 8:hdlr[0] + 12]) != b"vide":
        return None
    p, q = found[b"mdhd"]
    if data[p] == 1:
        timescale = struct.unpack_from(">I", data, p + 20)[0]
    else:
        timescale = struct.unpack_from(">I", data, p + 12)[0]
    # the first sample entry
    p, q = found[b"stsd"]
    entry = p + 8
    esize, etype = struct.unpack_from(">I4s", data, entry)
    width, height = struct.unpack_from(">HH", data, entry + 32)
    config = b""
    if etype in MP4_MPEG4:
        codec = "mpeg4"
        for typ, a, b in _boxes(data, entry + 86, entry + esize):
            if typ == b"esds":
                config = _esds_config(bytes(data[a:b]), path)
    elif etype in MP4_MJPEG:
        codec = "mjpeg"
    else:
        raise _refuse(path, _tag(etype))

    def table(name, fmt, per):
        if name not in found:
            return None
        a, _ = found[name]
        n = struct.unpack_from(">I", data, a + 4)[0]
        return [struct.unpack_from(fmt, data, a + 8 + i * per) for i in range(n)]

    stts = table(b"stts", ">II", 8) or []
    stsc = table(b"stsc", ">III", 12) or []
    if b"stco" in found:
        chunks = [c[0] for c in table(b"stco", ">I", 4)]
    elif b"co64" in found:
        chunks = [c[0] for c in table(b"co64", ">Q", 8)]
    else:
        raise ValueError(f"{path}: no chunk offsets (stco/co64)")
    if b"stsz" not in found:
        raise ValueError(f"{path}: no sample sizes (stsz)")
    a, _ = found[b"stsz"]
    fixed, count = struct.unpack_from(">II", data, a + 4)
    sizes = [fixed] * count if fixed else list(struct.unpack_from(f">{count}I", data, a + 12))
    samples = []
    k = 0
    for ci, off in enumerate(chunks):
        chunk = ci + 1
        per = 0
        for first, n, _ in stsc:
            if first <= chunk:
                per = n
        for _ in range(per):
            if k >= len(sizes):
                break
            samples.append((off, sizes[k]))
            off += sizes[k]
            k += 1
    if k != len(sizes):
        raise ValueError(f"{path}: the sample-to-chunk table covers {k} of {len(sizes)} samples")
    stss = table(b"stss", ">I", 4)
    duration = sum(n * d for n, d in stts)
    count = sum(n for n, _ in stts)
    fps = float(Fraction(timescale * count, duration)) if duration and count else 0.0
    return VideoTrack(path, codec, width, height, fps, len(samples), config, samples,
                      None if stss is None else [k - 1 for k, in stss])


# ---------------------------------------------------------------- AVI


def _chunks(f: BinaryIO, off: int, end: int):
    while off + 8 <= end:
        f.seek(off)
        cid, size = struct.unpack("<4sI", f.read(8))
        yield cid, off + 8, size
        off += 8 + size + (size & 1)


def _avi(path: str) -> VideoTrack:
    """The video stream's chunks as FFmpeg's AVI demuxer finds them: through
    the OpenDML index (``indx`` -> ``ix##``) where the stream has one, else
    ``idx1``, else a walk of the ``movi`` lists (RIFF AVI and AVIX)."""
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        info, idx1, movi, scanned = None, None, None, []
        for cid, off, size in _chunks(f, 0, fsize):  # RIFF AVI, then RIFF AVIX
            if cid != b"RIFF":
                continue
            for sid, soff, ssize in _chunks(f, off + 4, min(off + size, fsize)):
                f.seek(soff)
                if sid == b"LIST":
                    kind = f.read(4)
                    if kind == b"hdrl" and info is None:
                        info = _avi_hdrl(f, soff + 4, soff + ssize, path)
                    elif kind == b"movi":
                        movi = soff if movi is None else movi
                        if info is not None:
                            _avi_movi(f, soff + 4, min(soff + ssize, fsize), info["stream"],
                                      scanned)
                elif sid == b"idx1":
                    idx1 = (soff, ssize)
        if info is None:
            raise ValueError(f"{path}: no video stream (strh 'vids')")
        if info["indx"] is not None:
            samples = _avi_odml(f, info["indx"], path)
        elif idx1 is not None and movi is not None:
            samples = _avi_idx1(f, idx1, movi, info["stream"])
        else:
            samples = scanned
    samples = [s for s in samples if s[1]]  # a zero-size chunk is a dropped frame
    return VideoTrack(path, info["codec"], info["width"], info["height"], info["fps"],
                      info["length"] or len(samples), info["config"], samples)


def _avi_hdrl(f: BinaryIO, off: int, end: int, path: str) -> Optional[dict]:
    n = -1
    for cid, soff, size in _chunks(f, off, end):
        if cid != b"LIST":
            continue
        f.seek(soff)
        if f.read(4) != b"strl":
            continue
        n += 1
        strh = strf = indx = None
        for sid, poff, psize in _chunks(f, soff + 4, soff + size):
            f.seek(poff)
            if sid == b"strh":
                strh = f.read(psize)
            elif sid == b"strf":
                strf = f.read(psize)
            elif sid == b"indx":
                indx = f.read(psize)
        if strh is None or strh[:4] != b"vids":
            continue
        handler = strh[4:8]
        scale, rate, _start, length = struct.unpack_from("<IIII", strh, 20)
        width, height = struct.unpack_from("<ii", strf, 4)
        compression = strf[16:20]
        tags = {compression.upper(), handler.upper()}
        if tags & AVI_MPEG4:
            codec = "mpeg4"
        elif tags & AVI_MJPEG:
            codec = "mjpeg"
        else:
            raise _refuse(path, _tag(compression))
        return dict(stream=n, codec=codec, width=width, height=abs(height),
                    fps=float(Fraction(rate, scale)) if scale else 0.0, length=length,
                    config=bytes(strf[40:]), indx=indx)
    return None


def _avi_movi(f: BinaryIO, off: int, end: int, stream: int, samples: list) -> None:
    want = (b"%02ddc" % stream, b"%02ddb" % stream)
    for cid, soff, size in _chunks(f, off, end):
        if cid == b"LIST":
            _avi_movi(f, soff + 4, soff + size, stream, samples)
        elif cid in want:
            samples.append((soff, size))


def _avi_idx1(f: BinaryIO, idx1, movi: int, stream: int) -> List[Tuple[int, int]]:
    """idx1's entries of the stream; their offsets count from the 'movi'
    fourcc, or from the file's start in some writers (FFmpeg tells them
    apart by the first entry)."""
    off, size = idx1
    f.seek(off)
    raw = f.read(size)
    want = (b"%02ddc" % stream, b"%02ddb" % stream)
    entries = [struct.unpack_from("<4sIII", raw, i) for i in range(0, len(raw) - 15, 16)]
    entries = [(coff, csize) for cid, _, coff, csize in entries if cid in want]
    base = movi
    if entries:
        f.seek(movi + entries[0][0])
        if f.read(4) not in want:
            base = 0
    return [(base + coff + 8, csize) for coff, csize in entries]


def _avi_odml(f: BinaryIO, indx: bytes, path: str) -> List[Tuple[int, int]]:
    """The OpenDML super index's standard indexes (``ix##``): each entry's
    data offset from its chunk's base offset, its size without the
    key-frame bit."""
    longs, _sub, kind, n = struct.unpack_from("<HBBI", indx, 0)
    if kind != 0:  # AVI_INDEX_OF_INDEXES
        raise ValueError(f"{path}: OpenDML indx of type {kind}, not a super index")
    out = []
    for i in range(n):
        qoff, size, _ = struct.unpack_from("<QII", indx, 24 + 16 * i)
        f.seek(qoff + 8)
        ix = f.read(size - 8 if size > 8 else 0)
        if len(ix) < 24:
            raise ValueError(f"{path}: OpenDML index chunk at {qoff} runs past the file")
        _longs, _sub, _kind, count = struct.unpack_from("<HBBI", ix, 0)
        base = struct.unpack_from("<Q", ix, 12)[0]
        for j in range(count):
            doff, dsize = struct.unpack_from("<II", ix, 24 + 8 * j)
            out.append((base + doff, dsize & 0x7FFFFFFF))
    return out


# ---------------------------------------------------------------- Matroska

_SEGMENT, _INFO, _TRACKS, _CLUSTER = 0x18538067, 0x1549A966, 0x1654AE6B, 0x1F43B675
_TRACK_ENTRY, _TRACK_NUMBER, _TRACK_TYPE, _CODEC_ID = 0xAE, 0xD7, 0x83, 0x86
_CODEC_PRIVATE, _DEFAULT_DURATION, _VIDEO = 0x63A2, 0x23E383, 0xE0
_PIXEL_WIDTH, _PIXEL_HEIGHT, _CONTENT_ENCODINGS = 0xB0, 0xBA, 0x6D80
_TIMECODE_SCALE, _DURATION = 0x2AD7B1, 0x4489
_SIMPLE_BLOCK, _BLOCK_GROUP, _BLOCK = 0xA3, 0xA0, 0xA1
_UNKNOWN = -1


def _vint(data, off: int, keep_marker: bool):
    b = data[off]
    if b == 0:
        raise ValueError("EBML variable-length integer wider than 8 bytes")
    n = 1
    while not b & (0x80 >> (n - 1)):
        n += 1
    v = b if keep_marker else b & (0xFF >> n)
    for i in range(1, n):
        v = (v << 8) | data[off + i]
    if not keep_marker and v == (1 << (7 * n)) - 1:
        v = _UNKNOWN
    return v, off + n


def _elements(data, off: int, end: int):
    while off < end:
        eid, p = _vint(data, off, True)
        size, p = _vint(data, p, False)
        stop = end if size == _UNKNOWN else p + size
        if stop > end:
            stop = end
        yield eid, p, stop, size == _UNKNOWN
        off = stop


def _uint(data, a: int, b: int) -> int:
    return int.from_bytes(bytes(data[a:b]), "big")


def _mkv(path: str) -> VideoTrack:
    with _mapped(path) as data:
        return _mkv_segment(path, data)


def _mkv_segment(path: str, data) -> VideoTrack:
    scale, duration = 1000000, None
    video = None
    samples: List[Tuple[int, int]] = []
    for eid, p, e, _ in _elements(data, 0, len(data)):
        if eid != _SEGMENT:
            continue
        for sid, sp, se, unknown in _elements(data, p, e):
            if sid == _INFO:
                for iid, ip, ie, _ in _elements(data, sp, se):
                    if iid == _TIMECODE_SCALE:
                        scale = _uint(data, ip, ie)
                    elif iid == _DURATION:
                        duration = struct.unpack(">f" if ie - ip == 4 else ">d",
                                                 bytes(data[ip:ie]))[0]
            elif sid == _TRACKS and video is None:
                video = _mkv_tracks(data, sp, se, path)
            elif sid == _CLUSTER:
                if video is None:
                    raise ValueError(f"{path}: a cluster before the tracks")
                _mkv_cluster(data, sp, se, video["number"], samples, path)
        break
    if video is None:
        raise ValueError(f"{path}: no video track")
    fps = 0.0
    if video["default_duration"]:
        fps = float(Fraction(1000000000, video["default_duration"]).limit_denominator(30000))
    if duration is not None and fps:
        count = int(duration * scale / 1e9 * fps + 0.5)
    else:
        count = len(samples)
    return VideoTrack(path, video["codec"], video["width"], video["height"], fps, count,
                      video["private"], samples)


def _mkv_tracks(data, off: int, end: int, path: str):
    for tid, tp, te, _ in _elements(data, off, end):
        if tid != _TRACK_ENTRY:
            continue
        t = dict(number=0, type=0, codec_id="", private=b"", default_duration=0, width=0,
                 height=0, encoded=False)
        for eid, p, e, _ in _elements(data, tp, te):
            if eid == _TRACK_NUMBER:
                t["number"] = _uint(data, p, e)
            elif eid == _TRACK_TYPE:
                t["type"] = _uint(data, p, e)
            elif eid == _CODEC_ID:
                t["codec_id"] = bytes(data[p:e]).decode("ascii", "replace").rstrip("\0")
            elif eid == _CODEC_PRIVATE:
                t["private"] = bytes(data[p:e])
            elif eid == _DEFAULT_DURATION:
                t["default_duration"] = _uint(data, p, e)
            elif eid == _CONTENT_ENCODINGS:
                t["encoded"] = True
            elif eid == _VIDEO:
                for vid, vp, ve, _ in _elements(data, p, e):
                    if vid == _PIXEL_WIDTH:
                        t["width"] = _uint(data, vp, ve)
                    elif vid == _PIXEL_HEIGHT:
                        t["height"] = _uint(data, vp, ve)
        if t["type"] != 1:
            continue
        if t["codec_id"] in MKV_MPEG4:
            t["codec"] = "mpeg4"
        elif t["codec_id"] in MKV_MJPEG:
            t["codec"] = "mjpeg"
        else:
            raise _refuse(path, t["codec_id"])
        if t["encoded"]:
            raise ValueError(f"{path}: Matroska content encoding (compression or header "
                             "stripping) is not supported")
        return t
    return None


def _mkv_cluster(data, off: int, end: int, track: int, samples: list, path: str) -> None:
    for eid, p, e, _ in _elements(data, off, end):
        if eid == _BLOCK_GROUP:
            for bid, bp, be, _ in _elements(data, p, e):
                if bid == _BLOCK:
                    _mkv_block(data, bp, be, track, samples, path)
        elif eid == _SIMPLE_BLOCK:
            _mkv_block(data, p, e, track, samples, path)


def _mkv_block(data, p: int, e: int, track: int, samples: list, path: str) -> None:
    number, q = _vint(data, p, False)
    if number != track:
        return
    flags = data[q + 2]
    if flags & 0x06:
        raise ValueError(f"{path}: laced Matroska blocks are not supported")
    samples.append((q + 3, e - q - 3))


# ---------------------------------------------------------------- MP4 muxer


def _box(typ: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _full(typ: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags), *payload)


def _descr(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


def fps_timebase(fps: float) -> Tuple[int, int]:
    """(timescale, sample delta) for ``fps``: an integral rate as itself
    over 1, else the nearest fraction with a denominator up to 1001."""
    fr = Fraction(fps).limit_denominator(1001)
    if fr <= 0:
        raise ValueError(f"frame rate {fps} is not positive")
    return fr.numerator, fr.denominator


class Mp4Writer:
    """An ``.mp4`` with one MPEG-4 Part 2 video track, written as samples
    arrive: ``ftyp``, then ``mdat`` (its size fixed at ``close``), then
    ``moov``. ``config`` is the VOS + VO + VOL headers for the ``esds``."""

    def __init__(self, path: str, width: int, height: int, fps: float, config: bytes):
        self.path, self.width, self.height, self.config = path, width, height, config
        self.timescale, self.delta = fps_timebase(fps)
        self.sizes: List[int] = []
        self.max_size = 0
        self._f = None  # for close() from __del__ if the open fails
        self._f = open(path, "wb")
        self._f.write(_box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2mp41"))
        self.mdat_at = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 0))  # 64-bit size, fixed at close
        self.data_at = self._f.tell()

    def write(self, sample: bytes) -> None:
        self._f.write(sample)
        self.sizes.append(len(sample))
        self.max_size = max(self.max_size, len(sample))

    def close(self) -> None:
        if self._f is None:
            return
        f, self._f = self._f, None
        try:
            end = f.tell()
            f.seek(self.mdat_at + 8)
            f.write(struct.pack(">Q", end - self.mdat_at))
            f.seek(end)
            f.write(self._moov())
        finally:
            f.close()

    def _moov(self) -> bytes:
        n = len(self.sizes)
        media_duration = n * self.delta
        movie_duration = media_duration * 1000 // self.timescale
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_duration),
                     struct.pack(">IH10x", 0x10000, 0x100), matrix, bytes(24),
                     struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_duration),
                     bytes(8), struct.pack(">hhhH", 0, 0, 0, 0), matrix,
                     struct.pack(">II", self.width << 16, self.height << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, self.timescale, media_duration,
                                                0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0")
        avg = int(sum(self.sizes) * 8 * self.timescale / max(media_duration, 1))
        dcd = _descr(4, bytes([0x20, 0x11]) + struct.pack(">I", self.max_size)[1:]
                     + struct.pack(">II", avg, avg) + _descr(5, self.config))
        esds = _full(b"esds", 0, 0, _descr(3, struct.pack(">HB", 1, 0) + dcd
                                           + _descr(6, b"\x02")))
        compressor = bytes(32)
        mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1),
                    compressor, struct.pack(">Hh", 0x18, -1), esds)
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta))
        stss = _full(b"stss", 0, 0, struct.pack(">I", n),
                     struct.pack(f">{n}I", *range(1, n + 1)))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n), struct.pack(f">{n}I", *self.sizes))
        if self.data_at + sum(self.sizes) < 1 << 32:
            stco = _full(b"stco", 0, 0, struct.pack(">II", 1, self.data_at))
        else:
            stco = _full(b"co64", 0, 0, struct.pack(">IQ", 1, self.data_at))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)), dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)

    def __del__(self):
        self.close()
