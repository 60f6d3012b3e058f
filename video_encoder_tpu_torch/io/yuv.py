"""The port's own copy of `video_encoder_tpu/io/yuv.py`.

Raw YUV 4:2:0 and Y4M file I/O (reference component C3, SURVEY.md §2).

No ffmpeg in this environment (SURVEY.md §7): we read/write raw planar
I420 and the trivial Y4M container ourselves.
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, Iterator

import numpy as np


def frame_size_bytes(width: int, height: int) -> int:
    return width * height * 3 // 2


def split_i420(buf: bytes, width: int, height: int):
    """One I420 frame buffer → (y, cb, cr) uint8 arrays."""
    ysz, csz = width * height, (width // 2) * (height // 2)
    a = np.frombuffer(buf, dtype=np.uint8)
    y = a[:ysz].reshape(height, width)
    cb = a[ysz : ysz + csz].reshape(height // 2, width // 2)
    cr = a[ysz + csz : ysz + 2 * csz].reshape(height // 2, width // 2)
    return y, cb, cr


def join_i420(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> bytes:
    return y.tobytes() + cb.tobytes() + cr.tobytes()


def read_yuv_frames(
    f: BinaryIO, width: int, height: int, max_frames: int | None = None
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Iterate raw I420 frames from a file object."""
    fsz = frame_size_bytes(width, height)
    n = 0
    while max_frames is None or n < max_frames:
        buf = f.read(fsz)
        if len(buf) < fsz:
            return
        yield split_i420(buf, width, height)
        n += 1


def count_yuv_frames(path: str, width: int, height: int) -> int:
    return os.path.getsize(path) // frame_size_bytes(width, height)


def write_yuv_frame(f: BinaryIO, y, cb, cr) -> None:
    f.write(join_i420(np.asarray(y, np.uint8), np.asarray(cb, np.uint8), np.asarray(cr, np.uint8)))


# ---------------------------------------------------------------------------
# Y4M (YUV4MPEG2), 4:2:0 only
# ---------------------------------------------------------------------------


def read_y4m_header(f: BinaryIO) -> tuple[int, int, tuple[int, int]]:
    """Parse a YUV4MPEG2 header line → (width, height, (fps_num, fps_den))."""
    line = bytearray()
    while True:
        c = f.read(1)
        if not c or c == b"\n":
            break
        line += c
    parts = bytes(line).split(b" ")
    if not parts or parts[0] != b"YUV4MPEG2":
        raise ValueError("not a Y4M file")
    w = h = 0
    fps = (30, 1)
    for p in parts[1:]:
        if p.startswith(b"W"):
            w = int(p[1:])
        elif p.startswith(b"H"):
            h = int(p[1:])
        elif p.startswith(b"F"):
            num, den = p[1:].split(b":")
            fps = (int(num), int(den))
        elif p.startswith(b"C") and not p[1:].startswith(b"420"):
            raise ValueError(f"only 4:2:0 Y4M supported, got {p!r}")
    if not w or not h:
        raise ValueError("Y4M header missing W/H")
    return w, h, fps


def read_y4m_frames(
    f: BinaryIO, width: int, height: int
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    fsz = frame_size_bytes(width, height)
    while True:
        line = bytearray()
        while True:
            c = f.read(1)
            if not c:
                return
            if c == b"\n":
                break
            line += c
        if not bytes(line).startswith(b"FRAME"):
            raise ValueError(f"bad Y4M frame marker {bytes(line)!r}")
        buf = f.read(fsz)
        if len(buf) < fsz:
            return
        yield split_i420(buf, width, height)


def open_clip(path: str, width: int = 0, height: int = 0):
    """Open .y4m (self-describing) or raw .yuv (needs width/height).

    Returns (width, height, fps, frame_iterator).
    """
    f = open(path, "rb")
    if path.endswith(".y4m"):
        w, h, fps = read_y4m_header(f)
        return w, h, fps, read_y4m_frames(f, w, h)
    if not width or not height:
        raise ValueError("raw .yuv input requires explicit width/height")
    return width, height, (30, 1), read_yuv_frames(f, width, height)
