"""The port's video files (``data/video_container.py``, ``data/mpeg4.py``,
``data/video.py``) against cv2's FFmpeg backend, the JAX package's video
I/O, at small size on the CPU. cv2 writes the clips in ``tmp_path``: MPEG-4
Part 2 (fourcc ``mp4v``) in MP4, MOV, AVI and MKV, and Motion JPEG
(``MJPG``) in AVI and MKV, at 160x120 and at 98x66 (no multiple of 16),
each of 14 frames with motion, so that mp4v's P-VOPs follow its second
I-VOP (a GOP of 12).

- (a) the demuxers: each sample's bytes equal cv2's raw packet
  (``CAP_PROP_FORMAT -1``); frame count, fps, width and height equal cv2's.
- (b) the luma: first shown to be the Y plane (cv2's single-channel frame
  under ``CAP_PROP_CONVERT_RGB 0`` is the BT.601 luma of its own BGR frame,
  in the codec's range, and not a converted grey), then equal to the
  decoder's, bit for bit, mp4v and MJPEG alike (the MJPEG path runs
  libavcodec's simple IDCT, as FFmpeg's MJPEG decoder does).
- (c) the BGR frames: equal to ``cv2.VideoCapture``'s. The measured max
  |diff| is 0 on every clip (the colour conversion is swscale's x86 fixed
  point), so the bar is equality, tighter than 3 a sample and 0.5 a frame.
- (d) the writer: its ``.mp4`` reads back through ``cv2.VideoCapture`` with
  the frame count, fps and size given; each frame's PSNR against what was
  written is no lower than ``cv2.VideoWriter``'s on the same frames; the
  port reads its own file as cv2 does, under (b) and (c).

Also: longer clips with large motion and noise (the decoder's vectors,
rounding modes and intra macroblocks in P-VOPs); streams of libavcodec's
encoder, reached with ctypes, under the options cv2 cannot pass (4MV, MPEG
quantisation, resync markers, dquant), each frame equal to cv2's, and with
the features the port refuses; the refusals by name; and the fixtures of
``tests/data/torch_videos/`` against their manifest.
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from yolov6_tpu_torch.data import jpeg, mpeg4, video
from yolov6_tpu_torch.data.video_container import open_container

from torch_video_fixtures import FIXTURES, moving_frames

KINDS = [("mp4v", "mp4"), ("mp4v", "mov"), ("mp4v", "avi"), ("mp4v", "mkv"), ("MJPG", "avi"),
         ("MJPG", "mkv")]
SIZES = [(160, 120), (98, 66)]
N_FRAMES = 14
FPS = 30
CASES = [(f, e, w, h) for f, e in KINDS for w, h in SIZES]


def _ids(case):
    return f"{case[0]}-{case[1]}-{case[2]}x{case[3]}"


def _write_cv2(path, frames, fourcc="mp4v", fps=FPS):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()


def _read_cv2(path, *params):
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG, list(params))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def _read_port(path):
    cap = video.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(f)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    out = {}
    for i, (fourcc, ext, w, h) in enumerate(CASES):
        frames = moving_frames(w, h, N_FRAMES, seed=i)
        path = str(root / f"{fourcc}_{w}x{h}.{ext}")
        _write_cv2(path, frames, fourcc)
        out[(fourcc, ext, w, h)] = (path, frames)
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_demuxer_matches_cv2_packets(clips, case):
    path, _ = clips[case]
    track = open_container(path)
    packets = [bytes(p.reshape(-1)) for p in _read_cv2(path, cv2.CAP_PROP_FORMAT, -1)]
    assert len(track) == len(packets) == N_FRAMES
    assert all(track.sample(i) == p for i, p in enumerate(packets))
    track.close()
    cap, ours = cv2.VideoCapture(path), video.VideoCapture(path)
    for prop in (video.CAP_PROP_FRAME_COUNT, video.CAP_PROP_FPS, video.CAP_PROP_FRAME_WIDTH,
                 video.CAP_PROP_FRAME_HEIGHT):
        assert ours.get(prop) == cap.get(prop), prop
    assert track.codec == ("mpeg4" if case[0] == "mp4v" else "mjpeg")
    if case[:2] in (("mp4v", "mp4"), ("mp4v", "mov")):  # stss: mp4v's GOP of 12
        assert track.keyframes == [0, 12]


def _luma_of(bgr, full_range):
    b, g, r = (bgr[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return y if full_range else 16 + y * 219 / 255


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_luma_bit_exact(clips, case):
    path, _ = clips[case]
    full_range = case[0] == "MJPG"
    singles = _read_cv2(path, cv2.CAP_PROP_CONVERT_RGB, 0)
    bgrs = _read_cv2(path)
    # cv2's single-channel frame is the codec's Y plane: (h, w), the BT.601
    # luma of cv2's own BGR frame in the codec's range (limited for mp4v,
    # "yuvj" for MJPEG) within chroma's rounding and clipping (a level and a
    # half on average), and not cvtColor's grey
    for single, bgr in zip(singles, bgrs):
        assert single.shape == bgr.shape[:2] and single.dtype == np.uint8
        assert np.abs(single - _luma_of(bgr, full_range)).mean() < 1.5
        assert not np.array_equal(single, cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
        if not full_range:  # a full-range grey sits 3+ levels away on average
            assert np.abs(single - _luma_of(bgr, True)).mean() > 3.0
    track = open_container(path)
    if track.codec == "mpeg4":
        dec = mpeg4.Mpeg4Decoder(track.config, path)
        planes = [dec.decode(track.sample(i))[0] for i in range(len(track))]
        dec.close()
    else:
        planes = [jpeg.decode_jpeg_planes(track.sample(i))[0] for i in range(len(track))]
    track.close()
    assert len(planes) == len(singles) == N_FRAMES
    for i, (y, single) in enumerate(zip(planes, singles)):
        assert np.array_equal(y, single), f"frame {i}: max |diff| " \
            f"{np.abs(y.astype(int) - single).max()}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bgr_frames_equal_cv2(clips, case):
    path, _ = clips[case]
    want, got = _read_cv2(path), _read_port(path)
    assert len(got) == len(want) == N_FRAMES
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.uint8
        assert np.array_equal(g, w), f"frame {i}: max |diff| {np.abs(g.astype(int) - w).max()}"


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse) if mse else np.inf


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_writer(tmp_path, size):
    frames = moving_frames(*size, N_FRAMES, seed=7)
    ours, theirs = str(tmp_path / "ours.mp4"), str(tmp_path / "theirs.mp4")
    writer = video.VideoWriter(ours, FPS, size)
    for f in frames:
        writer.write(f)
    writer.release()
    _write_cv2(theirs, frames)
    cap = cv2.VideoCapture(ours)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == N_FRAMES and cap.get(cv2.CAP_PROP_FPS) == FPS
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == size
    back, back_cv2 = _read_cv2(ours), _read_cv2(theirs)
    assert len(back) == len(back_cv2) == N_FRAMES
    for f, a, b in zip(frames, back, back_cv2):
        assert _psnr(f, a) >= _psnr(f, b)
    # the port reads its own file as cv2 does
    assert all(np.array_equal(a, b) for a, b in zip(_read_port(ours), back))
    track = open_container(ours)
    dec = mpeg4.Mpeg4Decoder(track.config, ours)
    singles = _read_cv2(ours, cv2.CAP_PROP_CONVERT_RGB, 0)
    for i, single in enumerate(singles):
        assert np.array_equal(dec.decode(track.sample(i))[0], single)
    track.close()
    with pytest.raises(ValueError, match="frame of shape"):
        video.VideoWriter(str(tmp_path / "x.mp4"), FPS, size).write(frames[0][:-2])


@pytest.mark.parametrize("seed,size", [(1, (176, 144)), (2, (250, 130)), (3, (64, 48))])
def test_decoder_large_motion(tmp_path, seed, size):
    """40 frames at 25 fps with random shifts up to 12 px a frame and noise
    every seventh: long vectors (f_code > 1, unrestricted vectors past the
    edge), both rounding modes and intra macroblocks in P-VOPs."""
    w, h = size
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8),
                      (2 * w, 2 * h), interpolation=cv2.INTER_CUBIC)
    base[: h // 3, : w // 3] = 0
    base[-h // 4:, -w // 4:] = 255
    frames, x, y = [], 0, 0
    for i in range(40):
        x, y = x + int(rng.integers(-12, 13)), y + int(rng.integers(-9, 10))
        f = np.roll(np.roll(base, x, 1), y, 0)[:h, :w]
        if i % 7 == 3:
            f = np.clip(f.astype(int) + rng.integers(-40, 40, f.shape), 0, 255).astype(np.uint8)
        frames.append(np.ascontiguousarray(f))
    path = str(tmp_path / "motion.mp4")
    _write_cv2(path, frames, fps=25)
    want, got = _read_cv2(path), _read_port(path)
    assert len(got) == len(want) == 40
    assert all(np.array_equal(g, w_) for g, w_ in zip(got, want))


def test_avi_opendml_index(clips, tmp_path):
    """cv2's AVI (idx1 only below 1 GB) rewritten with an OpenDML index: the
    JUNK that FFmpeg reserves in the stream header becomes an ``indx`` whose
    one entry points at an ``ix00`` chunk after the RIFF, and idx1 becomes
    JUNK. cv2 and the port read the same packets through it."""
    path = clips[("mp4v", "avi", 160, 120)][0]
    track = open_container(path)
    samples = list(track.samples)
    track.close()
    data = bytearray(open(path, "rb").read())
    base = 0
    ix = struct.pack("<HBBI4sQI", 2, 0, 1, len(samples), b"00dc", base, 0) + b"".join(
        struct.pack("<II", off - base, size) for off, size in samples)
    ix_at = len(data)
    data += b"ix00" + struct.pack("<I", len(ix)) + ix
    junk = data.find(b"JUNK", data.find(b"strf"))
    size = struct.unpack_from("<I", data, junk + 4)[0]
    indx = struct.pack("<HBBI4s12xQII", 4, 0, 0, 1, b"00dc", ix_at, len(ix) + 8, len(samples))
    data[junk:junk + 8 + size] = b"indx" + struct.pack("<I", size) + indx.ljust(size, b"\0")
    i = data.find(b"idx1")
    data[i:i + 4] = b"JUNK"
    odml = tmp_path / "odml.avi"
    odml.write_bytes(bytes(data))
    track = open_container(str(odml))
    assert track.samples == samples
    track.close()
    packets = [bytes(p.reshape(-1)) for p in _read_cv2(str(odml), cv2.CAP_PROP_FORMAT, -1)]
    assert packets == [bytes(data[o:o + n]) for o, n in samples]
    assert all(np.array_equal(a, b) for a, b in zip(_read_port(str(odml)),
                                                    _read_cv2(str(odml))))


def _motion_clip(w, h, n, seed):
    """``n`` frames of a smooth texture shifted at random, up to 8 px a frame."""
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8),
                      (2 * w, 2 * h), interpolation=cv2.INTER_CUBIC)
    frames, x, y = [], 0, 0
    for _ in range(n):
        x, y = x + int(rng.integers(-8, 9)), y + int(rng.integers(-6, 7))
        frames.append(np.ascontiguousarray(np.roll(np.roll(base, x, 1), y, 0)[:h, :w]))
    return frames


# libavcodec's encoder options cv2's writer cannot pass: 4MV, MPEG quantisation
# (the default matrices), resync markers every 200 bytes, adaptive
# quantisation (dquant) under RD decisions and trellis, and all at once
LAVC_OPTIONS = {
    "mv4": [("flags", "+mv4")],
    "mpeg_quant": [("mpeg_quant", "1")],
    "resync": [("ps", "200")],
    "dquant": [("mbd", "rd"), ("trellis", "1"), ("lumi_mask", "0.3")],
    "combined": [("flags", "+mv4"), ("mpeg_quant", "1"), ("ps", "300"), ("lumi_mask", "0.3")],
}


@pytest.mark.parametrize("name", sorted(LAVC_OPTIONS))
def test_decoder_encoder_options(tmp_path, name):
    """Streams of libavcodec's own encoder under options cv2 cannot set,
    through ctypes (tests/torch_lavc.py): every frame equal to cv2's."""
    import torch_lavc

    path = str(tmp_path / f"{name}.mp4")
    torch_lavc.encode(_motion_clip(98, 66, 20, seed=4), [("g", "12"), *LAVC_OPTIONS[name]],
                      path)
    want, got = _read_cv2(path), _read_port(path)
    assert len(got) == len(want) == 20
    assert all(np.array_equal(g, w_) for g, w_ in zip(got, want))


@pytest.mark.parametrize("name,options,feature", [
    ("qpel", [("flags", "+qpel")], "quarter-pel"),
    ("bframes", [("bf", "2")], "B-VOP"),
    ("interlaced", [("flags", "+ildct+ilme")], "interlaced"),
    ("partitioned", [("data_partitioning", "1")], "data partitioning"),
])
def test_decoder_refuses_features(tmp_path, name, options, feature):
    """libavcodec's streams with a feature outside the port's subset raise
    ``ValueError`` naming it."""
    import torch_lavc

    path = str(tmp_path / f"{name}.mp4")
    torch_lavc.encode(_motion_clip(64, 48, 6, seed=5), [("g", "12"), *options], path)
    with pytest.raises(ValueError, match=feature):
        _read_port(path)


# ------------------------------------------------------------------ refusals


def test_mp4_avc1_refused(clips, tmp_path):
    path, _ = clips[("mp4v", "mp4", 160, 120)]
    data = open(path, "rb").read()
    assert data.count(b"mp4v") == 1
    bad = tmp_path / "h264.mp4"
    bad.write_bytes(data.replace(b"mp4v", b"avc1"))
    with pytest.raises(ValueError, match=r"'avc1' \(H\.264\)"):
        video.VideoCapture(str(bad))


def test_mkv_avc_refused(clips, tmp_path):
    path, _ = clips[("mp4v", "mkv", 160, 120)]
    data = open(path, "rb").read()
    assert data.count(b"V_MPEG4/ISO/ASP") == 1
    bad = tmp_path / "h264.mkv"
    bad.write_bytes(data.replace(b"V_MPEG4/ISO/ASP", b"V_MPEG4/ISO/AVC"))
    with pytest.raises(ValueError, match=r"V_MPEG4/ISO/AVC' \(H\.264\)"):
        video.VideoCapture(str(bad))


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self):
        self.put(1, 0)
        while len(self.bits) % 8:
            self.put(1, 1)
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def test_quarter_pel_vol_refused():
    """An Advanced Simple VOL (verid 2) with quarter_sample set."""
    b = _Bits()
    b.put(1, 0)  # random_accessible_vol
    b.put(8, 17)  # Advanced Simple
    b.put(1, 1)  # is_object_layer_identifier
    b.put(4, 2)  # verid 2: quarter_sample is coded
    b.put(3, 1)
    b.put(4, 1)  # square pixels
    b.put(1, 0)  # vol_control_parameters
    b.put(2, 0)  # rectangular
    for bits, val in ((1, 1), (16, 30), (1, 1), (1, 0), (1, 1), (13, 64), (1, 1), (13, 48),
                      (1, 1)):
        b.put(bits, val)
    b.put(1, 0)  # interlaced
    b.put(1, 1)  # obmc_disable
    b.put(2, 0)  # sprite_enable
    b.put(1, 0)  # not_8_bit
    b.put(1, 0)  # quant_type
    b.put(1, 1)  # quarter_sample
    vol = b"\x00\x00\x01\x20" + b.bytes()
    with pytest.raises(ValueError, match="quarter-pel"):
        mpeg4.Mpeg4Decoder(vol, "qpel.m4v")


def test_b_vop_refused(clips):
    """The first P-VOP of a clip with its vop_coding_type set to B."""
    path, _ = clips[("mp4v", "mp4", 160, 120)]
    track = open_container(path)
    dec = mpeg4.Mpeg4Decoder(track.config, path)
    assert dec.decode(track.sample(0)) is not None
    p_vop = bytearray(track.sample(1))
    i = p_vop.find(b"\x00\x00\x01\xb6")
    assert p_vop[i + 4] >> 6 == 1  # P
    p_vop[i + 4] = (p_vop[i + 4] & 0x3F) | 0x80  # B
    with pytest.raises(ValueError, match="B-VOP"):
        dec.decode(bytes(p_vop))
    track.close()


def test_other_containers_refused(tmp_path):
    bad = tmp_path / "clip.mp4"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not an MP4/MOV, AVI or Matroska file"):
        video.VideoCapture(str(bad))
    with pytest.raises(FileNotFoundError):
        video.VideoCapture(str(tmp_path / "missing.mp4"))


# ------------------------------------------------------------------ fixtures


def test_fixtures_match_manifest():
    """Each file of tests/data/torch_videos/ decodes in the port (and in
    cv2) to the manifest's frames, count, fps and size."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest) == 6 and sum(
        os.path.getsize(os.path.join(FIXTURES, n)) for n in manifest) < 400_000
    for name, want in manifest.items():
        path = os.path.join(FIXTURES, name)
        for frames in (_read_port(path), _read_cv2(path)):
            digest = hashlib.sha256(b"".join(f.tobytes() for f in frames)).hexdigest()
            assert (len(frames), digest) == (want["frames"], want["sha256"]), name
        cap = video.VideoCapture(path)
        assert cap.track.codec == want["codec"]
        assert (cap.get(video.CAP_PROP_FRAME_COUNT), cap.get(video.CAP_PROP_FPS),
                cap.get(video.CAP_PROP_FRAME_WIDTH), cap.get(video.CAP_PROP_FRAME_HEIGHT)) == (
            want["frame_count"], want["fps"], want["width"], want["height"])
        cap.release()


def test_mp4_writer_layout(tmp_path):
    """ftyp, mdat (64-bit size) then moov; one mp4v sample entry whose esds
    holds the VOL headers; stts at the fps as its timescale."""
    path = str(tmp_path / "w.mp4")
    writer = video.VideoWriter(path, 25, (64, 48))
    for f in moving_frames(64, 48, 3, seed=0):
        writer.write(f)
    writer.release()
    data = open(path, "rb").read()
    assert data[4:8] == b"ftyp"
    off = struct.unpack(">I", data[:4])[0]
    assert data[off + 4:off + 8] == b"mdat" and struct.unpack(">I", data[off:off + 4])[0] == 1
    mdat = struct.unpack(">Q", data[off + 8:off + 16])[0]
    assert data[off + mdat + 4:off + mdat + 8] == b"moov"
    track = open_container(path)
    assert (track.codec, track.width, track.height, track.fps, len(track)) == (
        "mpeg4", 64, 48, 25.0, 3)
    assert track.config == mpeg4.encode_headers(64, 48, 25)
    i = data.find(b"stts")
    assert struct.unpack(">III", data[i + 8:i + 20]) == (1, 3, 1)
    i = data.find(b"mdhd")
    assert struct.unpack(">I", data[i + 16:i + 20])[0] == 25
