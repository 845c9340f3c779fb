"""Writes the small video files of ``tests/data/torch_videos/`` with cv2
(``cv2.VideoWriter``: MPEG-4 Part 2 as fourcc ``mp4v`` in MP4, MOV, AVI and
MKV, Motion JPEG as ``MJPG`` in AVI and MKV), and ``manifest.json`` beside
them: for each file the frame count, fps, width and height that
``cv2.VideoCapture`` reports and the SHA-256 of the BGR frames it decodes,
one after another. ``chip_smoke.py`` [37a] holds the port's decoders, built
by the card machine's compiler, to that manifest;
``tests/test_torch_video.py`` holds the files to cv2 and the port here. Run
from the repository root to rewrite them:

    python tests/torch_video_fixtures.py
"""

import hashlib
import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "torch_videos")
# (fourcc, suffix, frames): mp4v's 14 frames hold its GOP of 12, so P-VOPs
# follow the second I-VOP; 98x66 is no multiple of 16
KINDS = (("mp4v", "mp4", 14), ("mp4v", "mov", 14), ("mp4v", "avi", 14), ("mp4v", "mkv", 14),
         ("MJPG", "avi", 6), ("MJPG", "mkv", 6))
SIZE = (98, 66)
FPS = 25


def moving_frames(w, h, n, seed):
    """A smooth texture with a black and a white patch, shifted 3 px right
    and 2 px down a frame (motion for the P-VOPs)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3), dtype=np.uint8)
    base = cv2.resize(base, (2 * w, 2 * h), interpolation=cv2.INTER_CUBIC)
    base[: h // 3, : w // 3] = 0
    base[-h // 4:, -w // 4:] = 255
    return [np.ascontiguousarray(np.roll(np.roll(base, 3 * i, 1), 2 * i, 0)[:h, :w])
            for i in range(n)]


def frames_sha256(frames) -> str:
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()


def main():
    os.makedirs(FIXTURES, exist_ok=True)
    manifest = {}
    for i, (fourcc, ext, n) in enumerate(KINDS):
        name = f"{fourcc.lower()}_{SIZE[0]}x{SIZE[1]}.{ext}"
        path = os.path.join(FIXTURES, name)
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS, SIZE)
        assert writer.isOpened(), name
        for f in moving_frames(*SIZE, n, seed=i):
            writer.write(f)
        writer.release()
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        manifest[name] = dict(
            codec="mpeg4" if fourcc == "mp4v" else "mjpeg",
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), fps=cap.get(cv2.CAP_PROP_FPS),
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), frames=len(frames),
            sha256=frames_sha256(frames))
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
